"""The LM side of the port (the counterpart of ``src/repro/models``): the
serving path of every decoder family (segment kinds ``attn_mlp``,
``attn_moe``, ``mla_mlp``, ``mla_moe``, ``mamba``, ``rwkv`` and zamba2's
``site``). ``registry.build(cfg)`` is the entry; the audio family raises
``NotImplementedError`` naming ROADMAP item 14a-iv."""
