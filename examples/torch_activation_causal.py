"""Bridge example on the PyTorch port (the counterpart of
``examples/activation_causal.py``): the paper's technique applied to
tensors produced by the model substrate — causal structure over a small
LM's hidden units.

Trains a tiny LM for a few steps, collects residual-stream activations
over a batch (the layers applied one by one over ``transformer.program``,
where the reference scans them), then runs cuPC-S on the unit-unit
correlation matrix to recover a (sparse) causal graph among hidden units.
Runs on the CUDA card; ``--device cpu`` runs on the CPU.

    PYTHONPATH=src python examples/torch_activation_causal.py [--steps 50] [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import pc_from_corr
from repro_torch.configs import ARCHS, TrainConfig
from repro_torch.data.lm_tokens import TokenPipeline
from repro_torch.models import registry as R
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        ARCHS["qwen3-1.7b"].reduced(), name="probe-lm", d_model=64, n_layers=2,
        n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256,
    )
    tcfg = TrainConfig(lr=1e-3, warmup=5, total_steps=args.steps, compute_dtype="float32")

    api = R.build(cfg, compute_dtype=torch.float32, device=args.device)
    params = api.init()
    opt = adamw_init(params)
    step = R.make_train_step(cfg, tcfg, device=args.device)
    pipe = TokenPipeline(cfg.vocab, 64, 8, device=args.device)
    losses = []
    for i in range(args.steps):
        params, opt, m = step(params, opt, pipe.batch(i))
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    print(f"[probe] trained {args.steps} steps, loss {losses[-1]:.3f}")

    # collect residual-stream activations (pre-unembed hidden states)
    with torch.no_grad():
        batch = pipe.batch(999)
        x, mask, positions = tf._embed_inputs(params, cfg, batch, torch.float32)
        for seg, seg_p in zip(tf.program(cfg), params["segments"]):
            for layer_p in seg_p:
                x, _aux, _state = tf.block_apply(layer_p, cfg, seg.kind, x, positions, mask)
    acts = x.reshape(-1, cfg.d_model).cpu().numpy()        # (tokens, units)
    m_samples = acts.shape[0]
    print(f"[probe] activations: {acts.shape} (tokens x hidden units)")

    # causal discovery over hidden units (cuPC-S on the correlation matrix)
    c = np.corrcoef(acts.T)
    run = pc_from_corr(c, m_samples, alpha=0.001, engine="S", max_level=2, device=args.device)
    n_edges = int(run.adj.sum()) // 2
    total = cfg.d_model * (cfg.d_model - 1) // 2
    print(f"[probe] cuPC-S: {n_edges}/{total} unit-unit edges survive "
          f"({run.levels_run} levels)  — sparse causal structure over neurons")
    print("[probe] timings:", {k: f"{v*1e3:.0f}ms" for k, v in run.timings_s.items()})
    return {"losses": losses, "acts": acts, "run": run, "edges": n_edges, "total": total}


if __name__ == "__main__":
    main()
