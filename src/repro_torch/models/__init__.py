"""The LM side of the port (the counterpart of ``src/repro/models``): the
serving path of the attention-MLP families (dense and vlm: segment kind
``attn_mlp``). ``registry.build(cfg)`` is the entry; the other segment
kinds raise ``NotImplementedError`` naming their ROADMAP item."""
