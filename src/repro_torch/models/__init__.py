"""The LM side of the port (the counterpart of ``src/repro/models``):
every architecture of ``configs.ARCHS``, the decoder segment kinds
(``attn_mlp``, ``attn_moe``, ``mla_mlp``, ``mla_moe``, ``mamba``, ``rwkv``
and zamba2's ``site``) and Whisper's encoder-decoder, served and trained.
``registry.build(cfg)`` is the entry, ``registry.make_train_step`` the
training step."""
