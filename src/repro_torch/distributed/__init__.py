from .supervisor import Supervisor, TrainResult  # noqa: F401
