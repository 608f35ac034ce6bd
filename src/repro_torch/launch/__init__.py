"""Command-line launchers of the port: ``pc_run`` (one PC-stable run, a
batch of graphs or a bootstrap ensemble) and ``pc_serve`` (a request
stream through ``serve.PCService``). Each has ``main(argv=None) -> int``
and runs on the CUDA card unless given ``--device cpu``."""
