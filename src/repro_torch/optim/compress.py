"""Int8 error-feedback gradient compression for the cross-pod mean (the
counterpart of ``src/repro/optim/compress.py``).

``compress_int8``: a symmetric per-tensor scale and round half to even,
bitwise the reference's. ``ef_compressed_mean`` quantizes each shard's
gradient on a scale shared over a named mesh axis, sums the int8 values in
int32 (exact, in rank order), dequantizes, and returns the residual
(g - dequant(q)) that error feedback adds to the next step's gradient, so
that the applied updates telescope to the true sum. The reference runs it
under ``shard_map``; the port takes the shards' tensors and does the
collectives as sums and maxima over them. Like the reference, nothing in
the training step calls it; it is provided for a caller that wants it."""
from __future__ import annotations

import torch


def compress_int8(g: torch.Tensor):
    """g → (q int8, scale () fp32)."""
    g32 = g.float()
    scale = g32.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(g32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compressed_mean(g, residual, axis_name: str, mesh):
    """Error-feedback int8 mean over ``axis_name`` of a named ``mesh``.

    ``g`` and ``residual``: one tensor a rank of the mesh (row-major), each
    on its rank's device. Ranks that differ only along ``axis_name`` form a
    group (the reference's ``shard_map`` collective), reduced in rank order.
    Returns (the fp32 means, the new fp32 residuals), one a rank."""
    devs = mesh.require_devices()
    if len(g) != mesh.size or len(residual) != mesh.size:
        raise ValueError(f"one gradient and one residual a rank of the {mesh.size}-rank mesh")
    groups: dict = {}
    for r in range(mesh.size):
        c = mesh.coords(r)
        groups.setdefault(tuple(v for a, v in c.items() if a != axis_name), []).append(r)
    means, new_res = [None] * mesh.size, [None] * mesh.size
    for ranks in groups.values():
        g32 = {r: g[r].float() + residual[r] for r in ranks}
        # one scale shared by the group (the reference's pmax of the amax), so
        # the int32 sum of q times the scale is the exact sum of the dequantized shards
        amax = g32[ranks[0]].abs().max()
        for r in ranks[1:]:
            amax = torch.maximum(amax, g32[r].abs().max().to(amax.device))
        scale = amax.clamp_min(1e-12) / 127.0
        acc = None
        for r in ranks:
            s_r = scale.to(devs[r])
            q = torch.round(g32[r] / s_r).clamp(-127, 127).to(torch.int8)
            new_res[r] = g32[r] - q.float() * s_r
            q32 = q.to(torch.int32).to(devs[ranks[0]])
            acc = q32 if acc is None else acc + q32
        npods = float(len(ranks))
        for r in ranks:
            means[r] = acc.to(devs[r]).float() * scale.to(devs[r]) / npods
    return means, new_res
