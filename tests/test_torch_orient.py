"""Orientation draws pinned: ``tests/test_batch.py::
test_property_cpdag_matches_serial_oracle``'s n = 11, density 0.375,
seed 1342 and n = 8, density 0.3125, seed 4939, from ``oracle_pc_stable``'s
skeleton and sepsets.

The port's ``core/orient.py::cpdag_from_skeleton`` is bitwise the JAX
one. Both orient 7 → 9; the serial ``cpdag_np`` leaves neither direction
(it deletes the edge). By hand, from the generating DAG (``adj[i, j]``
means Vj → Vi): 7's parents are 2, 3, 4 and 5, and 2 → 7 ← 5 is a
v-structure (2 and 5 are separated by {3}, without 7), so 5 → 7 is
compelled; 5 and 9 are not adjacent (separated by {2, 3, 4, 7}), so Meek
rule 1 compels 7 → 9, the DAG's own edge. ``cpdag_np`` first orients 7 → 9
by rule 1 (from 5); later in the same sweep it still reads 7 — 9 as
undirected (``und`` is computed once a sweep) and rule 4 (9 — 2, 2 → 4,
4 → 7, 9 adjacent to 4) removes 7 → 9 too. So the engines are right and
the serial oracle is wrong on this draw; the reference is not changed
here.

On the second draw ``cpdag_np`` deletes the edge 4 — 5 the same way. On
both, the engines' CPDAG is the one built from the generating DAG itself:
its v-structures, then Meek's rules applied one edge at a time until none
fires (``_dag_cpdag``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.orient import cpdag_from_skeleton  # noqa: E402
from repro_torch.data.synthetic_dag import sample_gaussian_dag  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.batch]

N, DENSITY, SEED = 11, 0.375, 1342


def test_pinned_draw_bitwise_reference_and_right():
    import jax.numpy as jnp

    from repro.core.orient import cpdag_from_skeleton as j_cpdag
    from repro.core.orient import cpdag_np
    from repro.data.synthetic_dag import oracle_pc_stable
    from repro.data.synthetic_dag import sample_gaussian_dag as j_sample

    _, dag = sample_gaussian_dag(n=N, m=10, density=DENSITY, seed=SEED)
    _, j_dag = j_sample(n=N, m=10, density=DENSITY, seed=SEED)
    assert np.array_equal(dag.adj, j_dag.adj)
    adj, sep_o = oracle_pc_stable(j_dag)
    assert np.array_equal(adj, dag.skeleton())
    sep = -np.ones((N, N, 8), np.int32)
    for (i, j), s in sep_o.items():
        sep[i, j, :len(s)] = s
        sep[j, i, :len(s)] = s
    got = cpdag_from_skeleton(torch.tensor(adj), torch.tensor(sep)).numpy()
    want = np.asarray(j_cpdag(jnp.asarray(adj), jnp.asarray(sep)))
    assert np.array_equal(got, want)

    # the hand derivation: 2 → 7 ← 5 a v-structure, 5 and 9 non-adjacent
    assert dag.adj[7, 2] and dag.adj[7, 5] and not adj[2, 5] and 7 not in sep_o[(2, 5)]
    assert not adj[5, 9] and dag.adj[9, 7]
    assert got[5, 7] and not got[7, 5]
    assert got[7, 9] and not got[9, 7]  # 7 → 9, the DAG's edge
    # the serial oracle differs in that one cell pair: it drops the edge
    ref = cpdag_np(adj, sep_o)
    assert not ref[7, 9] and not ref[9, 7]
    diff = np.argwhere(got != ref)
    assert diff.tolist() == [[7, 9]]
    # every skeleton edge survives in the port's CPDAG
    assert np.array_equal(got | got.T, adj)


def _dag_cpdag(parents, skel):
    """The CPDAG of a DAG (``parents[i, j]`` means Vj → Vi), as the engines
    lay it out: ``cp[a, b]`` and not ``cp[b, a]`` is a → b, both is a — b."""
    n = len(skel)
    cp = skel.copy()
    for k in range(n):
        pa = np.flatnonzero(parents[k])
        for i in pa:
            for j in pa:
                if i < j and not skel[i, j]:
                    cp[k, i] = cp[k, j] = False

    def und(a, b):
        return cp[a, b] and cp[b, a]

    def arrow(a, b):
        return cp[a, b] and not cp[b, a]

    def near(a, b):
        return cp[a, b] or cp[b, a]

    nodes = range(n)
    changed = True
    while changed:
        changed = False
        for a in nodes:
            for b in nodes:
                if a == b or not und(a, b):
                    continue
                if (any(arrow(c, a) and not near(c, b) for c in nodes)
                        or any(arrow(a, c) and arrow(c, b) for c in nodes)
                        or any(und(a, c) and und(a, d) and arrow(c, b) and arrow(d, b)
                               and not near(c, d) for c in nodes for d in nodes if c != d)
                        or any(near(a, c) and arrow(c, d) and arrow(d, b) and near(a, d)
                               and not near(c, b) for c in nodes for d in nodes)):
                    cp[b, a] = False
                    changed = True
    return cp


@pytest.mark.parametrize("n,density,seed,dropped", [
    (11, 0.375, 1342, [[7, 9]]),
    (8, 0.3125, 4939, [[4, 5], [5, 4]]),
])
def test_pinned_draws_orient_the_dags_cpdag(n, density, seed, dropped):
    import jax.numpy as jnp

    from repro.core.orient import cpdag_from_skeleton as j_cpdag
    from repro.core.orient import cpdag_np
    from repro.data.synthetic_dag import oracle_pc_stable
    from repro.data.synthetic_dag import sample_gaussian_dag as j_sample

    _, dag = sample_gaussian_dag(n=n, m=10, density=density, seed=seed)
    _, j_dag = j_sample(n=n, m=10, density=density, seed=seed)
    assert np.array_equal(dag.adj, j_dag.adj)
    adj, sep_o = oracle_pc_stable(j_dag)
    assert np.array_equal(adj, dag.skeleton())
    sep = -np.ones((n, n, 8), np.int32)
    for (i, j), s in sep_o.items():
        sep[i, j, :len(s)] = s
        sep[j, i, :len(s)] = s
    got = cpdag_from_skeleton(torch.tensor(adj), torch.tensor(sep)).numpy()
    assert np.array_equal(got, np.asarray(j_cpdag(jnp.asarray(adj), jnp.asarray(sep))))
    assert np.array_equal(got, _dag_cpdag(dag.adj.astype(bool), adj.astype(bool)))
    # the serial oracle deletes one skeleton edge the engines keep
    ref = cpdag_np(adj, sep_o)
    diff = np.argwhere(got != ref).tolist()
    assert diff == dropped
    assert all(got[i, j] and not ref[i, j] and not ref[j, i] for i, j in diff)
