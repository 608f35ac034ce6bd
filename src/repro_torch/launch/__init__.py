"""Command-line launchers of the port: ``pc_run`` (one PC-stable run, a
batch of graphs or a bootstrap ensemble), ``pc_serve`` (a request stream
through ``serve.PCService``), ``serve`` (LM prefill and greedy decode) and
``train`` (LM training under the checkpoint-restart supervisor). Each has
``main(argv=None) -> int`` and runs on the CUDA card unless given
``--device cpu``."""
