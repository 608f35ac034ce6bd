"""The port's LM sharding planner (``repro_torch.models.sharding``) and the
dry run's stand-ins (``registry.input_specs``, ``abstract_params``,
``abstract_opt_state``, ``abstract_cache``) against the JAX package's, for
all ten architectures at full width: abstract trees only, nothing is
allocated on either side.

The reference's planner needs a mesh of real devices, so its side runs
once, in one subprocess with eight forced host devices, and hands back
every leaf's path, shape, dtype and spec on the (pod, data, model) =
(2, 2, 2) and (data, model) = (2, 4) meshes. The port plans on named
meshes of logical CPU shards of the same shapes.

* ``param_specs``: spec for spec; a stacked reference leaf (L, ...) is the
  port's L layer leaves (``tree.stacked_groups``), its spec ``(None,
  *the port's)``;
* ``opt_specs`` (with and without ``master_fp32``) and
  ``abstract_opt_state``;
* ``input_specs`` and ``batch_specs`` for every supported architecture ×
  ``SHAPES`` cell, ``abstract_cache`` and ``cache_specs`` for its prefill
  and decode cells;
* the production meshes (16, 16) and (2, 16, 16): every split dimension
  divides its axes.

Exact equality throughout: specs compare axis for axis (an entry naming
one axis as a string or a 1-tuple is the same split).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as TT  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.core.sharding import Spec  # noqa: E402
from repro_torch.launch.mesh import make_lm_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.distributed]

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"pdm": ((2, 2, 2), ("pod", "data", "model")), "dm": ((2, 4), ("data", "model"))}

_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from repro.configs import ARCHS, SHAPES
    from repro.models import registry as R, sharding as SH

    MESHES = json.loads(sys.argv[2])
    meshes = {k: jax.make_mesh(tuple(s), tuple(a)) for k, (s, a) in MESHES.items()}

    def spec(s):
        return [None if e is None else ([e] if isinstance(e, str) else list(e)) for e in s.spec]

    def rows(tree, specs=None):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        out = [dict(path=jax.tree_util.keystr(p), shape=list(x.shape), dtype=str(x.dtype))
               for p, x in leaves]
        if specs is not None:
            for key, sp in specs.items():
                flat = jax.tree.leaves(sp, is_leaf=lambda x: hasattr(x, "spec"))
                assert len(flat) == len(out)
                for row, s in zip(out, flat):
                    row[key] = spec(s)
        return out

    out = {}
    for arch, cfg in ARCHS.items():
        pa = R.abstract_params(cfg, jnp.float32)
        ps = {k: SH.param_specs(cfg, pa, m) for k, m in meshes.items()}
        rec = {"params": rows(pa, ps)}
        for master in (False, True):
            oa = R.abstract_opt_state(pa, master)
            rec[f"opt_{master}"] = rows(oa, {k: SH.opt_specs(cfg, oa, m, ps[k])
                                             for k, m in meshes.items()})
        cells = {}
        for name, cell in SHAPES.items():
            if not R.supports_cell(cfg, cell)[0]:
                continue
            ba = R.input_specs(cfg, cell)
            c = {"batch": rows(ba, {k: SH.batch_specs(cfg, ba, m) for k, m in meshes.items()})}
            if cell.kind != "train":
                ca = R.abstract_cache(cfg, cell.global_batch, cell.seq_len)
                c["cache"] = rows(ca, {k: SH.cache_specs(cfg, ca, m) for k, m in meshes.items()})
            cells[name] = c
        rec["cells"] = cells
        out[arch] = rec
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    print("OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference leaf, once for the file (one subprocess)."""
    path = tmp_path_factory.mktemp("lm_sharding") / "ref.json"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(path), json.dumps(MESHES)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert "OK" in proc.stdout, proc.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes():
    return {k: make_lm_mesh(s, a, devices=("cpu",) * 8) for k, (s, a) in MESHES.items()}


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _norm(spec, ndim):
    """A spec as one tuple of axis names a dimension."""
    spec = list(spec) + [None] * (ndim - len(spec))
    return tuple(_axes(e) for e in spec)


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _name(path) -> str:
    return next(k for k in reversed(path) if isinstance(k, str))


def _check_grouped(tree, spec_trees, ref_rows, what):
    """The port's leaves of ``tree`` (grouped into the reference's stacked
    leaves) against the reference rows: shape, dtype, name and, for each
    mesh, the spec."""
    named = TT.flatten_with_path(tree)
    groups = TT.stacked_groups(tree)
    specs = {k: TT.leaves(s) for k, s in spec_trees.items()}
    assert all(len(s) == len(named) for s in specs.values())
    assert len(groups) == len(ref_rows), f"{what}: {len(groups)} leaves against {len(ref_rows)}"
    for group, row in zip(groups, ref_rows):
        path, leaf = named[group[0]]
        assert row["path"].endswith(f"['{_name(path)}']"), (what, row["path"], path)
        stacked = any(isinstance(k, TT.Layer) for k in path)
        shape = [len(group), *leaf.shape] if stacked else list(leaf.shape)
        assert shape == row["shape"] and _dtype(leaf) == row["dtype"], (what, row, path)
        for j, i in enumerate(group):  # layer j of the stack
            p_i, x_i = named[i]
            assert tuple(x_i.shape) == tuple(leaf.shape), (what, p_i)
            assert [k for k in p_i if isinstance(k, TT.Layer)] == ([j] if stacked else []), \
                (what, p_i)
        for key, flat in specs.items():
            want = _norm(row[key], len(row["shape"]))
            for i in group:
                assert isinstance(flat[i], Spec), (what, key, path)
                got = _norm(flat[i], leaf.ndim)
                assert (((),) + got if stacked else got) == want, \
                    (what, key, row["path"], got, want)


def _check_flat(tree, spec_trees, ref_rows, what):
    """Trees the port keeps in the reference's layout (batches, caches):
    leaf for leaf."""
    named = TT.flatten_with_path(tree)
    specs = {k: TT.leaves(s) for k, s in spec_trees.items()}
    assert len(named) == len(ref_rows), f"{what}: {len(named)} leaves against {len(ref_rows)}"
    for i, ((path, leaf), row) in enumerate(zip(named, ref_rows)):
        if any(isinstance(k, str) for k in path):
            assert row["path"].endswith(f"['{_name(path)}']"), (what, row["path"], path)
        assert list(leaf.shape) == row["shape"] and _dtype(leaf) == row["dtype"], (what, row)
        assert leaf.device.type == "meta", (what, path)
        for key, flat in specs.items():
            assert _norm(flat[i], leaf.ndim) == _norm(row[key], leaf.ndim), (what, key, row)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs(ref, meshes, arch):
    cfg = ARCHS[arch]
    params = TR.abstract_params(cfg)
    assert all(x.device.type == "meta" for x in TT.leaves(params))
    specs = {k: SH.param_specs(cfg, params, m) for k, m in meshes.items()}
    assert TT.treedef_str(specs["pdm"]) == TT.treedef_str(params)
    _check_grouped(params, specs, ref[arch]["params"], f"{arch} params")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_specs(ref, meshes, arch):
    cfg = ARCHS[arch]
    params = TR.abstract_params(cfg)
    for master in (False, True):
        opt = TR.abstract_opt_state(params, master)
        assert ("master" in opt) == master
        specs = {k: SH.opt_specs(cfg, opt, m, SH.param_specs(cfg, params, m))
                 for k, m in meshes.items()}
        _check_grouped(opt, specs, ref[arch][f"opt_{master}"], f"{arch} opt master={master}")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_batch_and_cache_specs(ref, meshes, arch):
    cfg = ARCHS[arch]
    cells = ref[arch]["cells"]
    assert sorted(cells) == sorted(n for n, c in SHAPES.items() if TR.supports_cell(cfg, c)[0])
    for name, want in cells.items():
        cell = SHAPES[name]
        batch = TR.input_specs(cfg, cell)
        _check_flat(batch, {k: SH.batch_specs(cfg, batch, m) for k, m in meshes.items()},
                    want["batch"], f"{arch} {name} batch")
        if cell.kind != "train":
            cache = TR.abstract_cache(cfg, cell.global_batch, cell.seq_len)
            _check_flat(cache, {k: SH.cache_specs(cfg, cache, m) for k, m in meshes.items()},
                        want["cache"], f"{arch} {name} cache")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_production_meshes_divide(arch):
    """At (16, 16) and (2, 16, 16), planning meshes without devices: every
    split dimension of the parameters and the fp32-master optimizer state
    divides its axes."""
    cfg = ARCHS[arch]
    params = TR.abstract_params(cfg)
    opt = TR.abstract_opt_state(params, True)
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert mesh.devices is None and mesh.size == (512 if multi_pod else 256)
        pspecs = SH.param_specs(cfg, params, mesh)
        for tree, specs in ((params, pspecs), (opt, SH.opt_specs(cfg, opt, mesh, pspecs))):
            for leaf, spec in zip(TT.leaves(tree), TT.leaves(specs)):
                assert len(spec) == leaf.ndim
                for dim, entry in zip(leaf.shape, spec):
                    assert dim % mesh.axis_size(entry) == 0, (arch, leaf.shape, spec)
