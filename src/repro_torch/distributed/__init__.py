from .elastic import remesh  # noqa: F401
from .pipeline import pipeline_apply  # noqa: F401
from .supervisor import Supervisor, TrainResult  # noqa: F401
