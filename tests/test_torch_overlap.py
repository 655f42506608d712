"""The port's decomposed-collective layer (``repro_torch.core.overlap``)
against dense numpy answers -- those of ``tests/test_overlap.py`` -- on
``SimMesh(4)`` and ``SimMesh(8)``, over each axis of a 2x4 grid, with the
ring's gradient (``2x`` through ``ring_all_gather``, and the dense
autograd of ``collective_matmul_ag``), and against the reference itself:
one subprocess over 8 host devices runs the reference's four functions
on the same seeded inputs, with ``chunk_fn``\\ s that weight each chunk by
its ``src``, so hop order and source numbering are compared too. The
same functions over a gloo ``ProcessGroupMesh`` at P = 4 ride in the
spawn of ``tests/test_torch_serve_spmd.py``."""

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.core import (
    SimMesh, collective_matmul_ag, ring_all_gather, ring_reduce_scatter, ring_scatter_reduce,
)
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

AX = "model"


def _inputs():
    """test_overlap.py's inputs, in its draw order."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((8, 16)).astype(np.float32)
    xm = rng.standard_normal((4, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    return v, xm, w, x


def _weighted(chunk, src):
    return chunk * (src + 1.0)


def _blocks(mesh, a, tail):
    return mesh.split(torch.from_numpy(a), tail)


def _np(ts):
    return [t.detach().numpy() for t in ts]


def port_outputs(p):
    """Every case on SimMesh(p), one entry per rank."""
    v, xm, w, x = _inputs()
    mesh = SimMesh(p, device="cpu")
    rows, cols = (AX, None), (None, AX)
    return {
        "gather": _np(ring_all_gather(_blocks(mesh, v, rows), mesh, AX, axis=0)),
        "gather_weighted": _np(ring_all_gather(_blocks(mesh, v, rows), mesh, AX, _weighted, axis=0)),
        "reduce_scatter": _np(ring_reduce_scatter(_blocks(mesh, v, rows), mesh, AX, axis=-1)),
        "matmul": _np(collective_matmul_ag(_blocks(mesh, xm, cols), torch.from_numpy(w), mesh, AX)),
        "scatter_reduce": _np(ring_scatter_reduce(_blocks(mesh, x, rows), mesh, AX, lambda c, s: c * 1.0)),
        "scatter_reduce_weighted": _np(ring_scatter_reduce(_blocks(mesh, x, rows), mesh, AX, _weighted)),
    }


def dense(p):
    """The same cases from numpy alone."""
    v, xm, w, x = _inputs()
    vb, xb = np.split(v, p), np.split(x, p)
    sum_v, sum_x = sum(vb), sum(xb)
    return {
        "gather": [v] * p,
        "gather_weighted": [sum((s + 1.0) * vb[s] for s in range(p))] * p,
        "reduce_scatter": np.split(sum_v, p, axis=-1),
        "matmul": [xm @ w] * p,
        "scatter_reduce": np.split(sum_x, p, axis=-1),
        "scatter_reduce_weighted": [sum((s + 1.0) * xb[s] for s in range(p))[:, r * (32 // p):(r + 1) * (32 // p)]
                                    for r in range(p)],
    }


@pytest.mark.parametrize("p", [4, 8])
def test_rings_on_sim_mesh_match_the_dense_answers(p):
    got, exp = port_outputs(p), dense(p)
    for case in exp:
        assert len(got[case]) == p
        for g, e in zip(got[case], exp[case]):
            np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-4, err_msg=case)


@pytest.mark.parametrize("p", [4, 8])
def test_the_ring_gradient_is_2x(p):
    v = _inputs()[0]
    mesh = SimMesh(p, device="cpu")
    xs = [b.clone().requires_grad_(True) for b in _blocks(mesh, v, (AX, None))]
    outs = ring_all_gather(xs, mesh, AX, axis=0)
    (sum((o ** 2).sum() for o in outs) / p).backward()  # the ranks' mean of sum(gather(x)^2)
    np.testing.assert_allclose(torch.cat([x.grad for x in xs]).numpy(), 2 * v, rtol=1e-6, atol=1e-5)


def test_collective_matmul_gradient_equals_the_dense_autograd():
    _, xm, w, _ = _inputs()
    mesh = SimMesh(4, device="cpu")
    xs = [b.clone().requires_grad_(True) for b in _blocks(mesh, xm, (None, AX))]
    wt = torch.from_numpy(w).requires_grad_(True)
    sum(((y - 1.0) ** 2).sum() for y in collective_matmul_ag(xs, wt, mesh, AX)).backward()
    xd, wd = torch.from_numpy(xm).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    (4 * ((xd @ wd - 1.0) ** 2).sum()).backward()
    np.testing.assert_allclose(torch.cat([x.grad for x in xs], dim=-1).numpy(), xd.grad.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(wt.grad.numpy(), wd.grad.numpy(), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_rings_run_over_each_axis_of_a_grid(axis):
    grid = SimMesh((2, 4), axis_names=("rows", "cols"), device="cpu")
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)) for _ in range(grid.p)]
    gathered = ring_all_gather(xs, grid, axis, axis=0)
    reduced = ring_reduce_scatter(xs, grid, axis, axis=-1)
    for ring in grid.ring_ranks(axis):
        k = len(ring)
        total = sum(xs[r] for r in ring)
        for i, r in enumerate(ring):
            assert torch.equal(gathered[r], torch.cat([xs[q] for q in ring]))
            torch.testing.assert_close(reduced[r], total[:, i * (8 // k):(i + 1) * (8 // k)])


def test_one_rank_rings_return_their_input():
    mesh = SimMesh(1, device="cpu")
    x = torch.arange(6.0).reshape(2, 3)
    assert ring_all_gather([x], mesh, AX)[0] is x and ring_reduce_scatter([x], mesh, AX)[0] is x
    torch.testing.assert_close(ring_scatter_reduce([x], mesh, AX, _weighted)[0], x)
    with pytest.raises(ValueError, match="not divisible by 4"):
        ring_reduce_scatter([torch.zeros(2, 6)] * 4, SimMesh(4, device="cpu"), AX)


REF_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.compat import make_mesh, shard_map
from repro.core import (collective_matmul_ag, ring_all_gather,
                        ring_reduce_scatter, ring_scatter_reduce)

mesh = make_mesh((8,), ("model",))
rng = np.random.default_rng(0)
v = rng.standard_normal((8, 16)).astype(np.float32)
xm = rng.standard_normal((4, 32)).astype(np.float32)
w = rng.standard_normal((32, 16)).astype(np.float32)
x = rng.standard_normal((8, 32)).astype(np.float32)
R, C = P("model", None), P(None, "model")
wt = lambda c, s: c * (s + 1.0)
def body(v, xm, x):
    # one row of the stacked outputs per rank
    return {
        "gather": ring_all_gather(v, "model", axis=0)[None],
        "gather_weighted": ring_all_gather(v, "model", wt, axis=0),
        "reduce_scatter": ring_reduce_scatter(v, "model", axis=-1),
        "matmul": collective_matmul_ag(xm, jnp.asarray(w), "model")[None],
        "scatter_reduce": ring_scatter_reduce(x, "model", lambda c, s: c * 1.0),
        "scatter_reduce_weighted": ring_scatter_reduce(x, "model", wt),
    }
def loss(a):
    f = lambda al: (ring_all_gather(al, "model", axis=0) ** 2).sum()
    return shard_map(f, mesh=mesh, in_specs=R, out_specs=P(), check_vma=False)(a)
def everything(v, xm, x):  # one compile for every case
    out = shard_map(body, mesh=mesh, in_specs=(R, C, R), out_specs=P("model"), check_vma=False)(v, xm, x)
    return dict(out, grad=jax.grad(loss)(v))
out = {k: np.asarray(a) for k, a in jax.jit(everything)(jnp.asarray(v), jnp.asarray(xm), jnp.asarray(x)).items()}
np.savez(OUT, **out)
print("PASS")
"""


def test_rings_equal_the_references_at_8_devices(tmp_path):
    path = str(tmp_path / "ref.npz")
    assert "PASS" in run_subprocess(f"OUT = {path!r}\n" + REF_CODE, devices=8)
    ref = np.load(path)
    got = port_outputs(8)
    for case, blocks in got.items():
        exp = ref[case]
        exp = [exp[r] for r in range(8)] if case in ("gather", "matmul") else np.split(exp, 8)
        for g, e in zip(blocks, exp):
            np.testing.assert_allclose(g, e, rtol=1e-6, atol=1e-5, err_msg=case)
    v = _inputs()[0]
    mesh = SimMesh(8, device="cpu")
    xs = [b.clone().requires_grad_(True) for b in _blocks(mesh, v, (AX, None))]
    (sum((o ** 2).sum() for o in ring_all_gather(xs, mesh, AX, axis=0)) / 8).backward()
    np.testing.assert_allclose(torch.cat([x.grad for x in xs]).numpy(), ref["grad"], rtol=1e-6, atol=1e-5)
