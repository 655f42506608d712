"""The port's exchanges on the simulated mesh: every backend's
distributed_transpose against numpy's transpose of the gathered array,
the registry and cost-model tests of tests/test_backends.py against the
port's registry, transpose_then_fft (fused and unfused) against
numpy.fft, and the SimMesh primitives."""

import numpy as np
import pytest
import torch

from repro_torch.core import SimMesh, backends, comm_model
from repro_torch.core import transpose as tr
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

PS = (1, 2, 4, 8)
PAPER_STRATEGIES = {"alltoall", "scatter", "bisection", "xla_auto"}


def _c64(seed, shape):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) + 1j * r.standard_normal(shape)).astype(np.complex64)


def _blocks(x, p):
    return list(torch.chunk(torch.from_numpy(x), p, dim=-2))


def _gather_cols(blocks):
    return torch.cat(blocks, dim=-2).numpy()  # (..., C, R): C sharded


def _shard_map_backends(p):
    return [n for n in backends.supporting(p, kind="shard_map")]


# ---------------------------------------------------------------------------
# transposes vs numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", PS)
def test_every_backend_transposes_like_numpy(p):
    mesh = SimMesh(p, device="cpu")
    x = _c64(p, (3, 2 * p, 4 * p))  # (batch, R, C)
    for name in _shard_map_backends(p):
        for n_chunks in (None, 2 * p):
            got = _gather_cols(tr.distributed_transpose(
                _blocks(x, p), mesh, "model", strategy=name, n_chunks=n_chunks))
            np.testing.assert_array_equal(got, np.swapaxes(x, -1, -2), err_msg=f"{name} p={p}")


@pytest.mark.parametrize("p", [2, 4, 8])
def test_streaming_chunk_fns_see_sources_and_offsets(p):
    """3-arg chunk_fns get each sub-chunk with its source rank and row
    offset; 2-arg chunk_fns get the reassembled peer block."""
    mesh = SimMesh(p, device="cpu")
    x = _c64(10 + p, (2 * p, 4 * p))
    r = x.shape[0] // p
    for name in ("scatter", "pairwise_xor"):
        seen = []

        def tag3(chunk, src, offset):
            seen.append((mesh.axis_index("model"), src, offset, chunk.shape[-1]))
            return chunk * (src + 1)

        got = _gather_cols(tr.distributed_transpose(
            _blocks(x, p), mesh, "model", strategy=name, chunk_fn=tag3, n_chunks=2 * p))
        scale = np.repeat(np.arange(1, p + 1), r)  # source rank of each global row
        np.testing.assert_allclose(got, x.T * scale[None, :], rtol=1e-6)
        assert {(me, src) for me, src, _, _ in seen} == {(me, s) for me in range(p) for s in range(p)}
        assert {off for _, _, off, _ in seen} == {0, r // 2}

        def tag2(chunk, src):
            assert chunk.shape[-1] == r  # whole peer block
            return chunk * (src + 1)

        got = _gather_cols(tr.distributed_transpose(
            _blocks(x, p), mesh, "model", strategy=name, chunk_fn=tag2, n_chunks=2 * p))
        np.testing.assert_allclose(got, x.T * scale[None, :], rtol=1e-6)


def test_transpose_guards():
    mesh = SimMesh(4, device="cpu")
    xs = _blocks(_c64(0, (8, 10)), 4)
    with pytest.raises(ValueError, match="column count 10 not divisible by the 4 shards"):
        tr.distributed_transpose(xs, mesh, "model", strategy="scatter")
    xs = _blocks(_c64(0, (8, 8)), 4)
    with pytest.raises(ValueError, match="chunk_fn requires a chunk-streaming backend"):
        tr.distributed_transpose(xs, mesh, "model", strategy="alltoall", chunk_fn=lambda c, s: c)
    with pytest.raises(ValueError, match="whole-transform backend"):
        tr.distributed_transpose(xs, mesh, "model", strategy="xla_auto")
    mesh3 = SimMesh(3, device="cpu")
    with pytest.raises(ValueError, match="does not support P=3"):
        tr.distributed_transpose(_blocks(_c64(0, (6, 6)), 3), mesh3, "model", strategy="pairwise_xor")


def test_subchunks_per_peer_matches_reference():
    from repro.core import comm_model as ref_cm
    from repro.core import transpose as ref_tr

    for r in (1, 2, 6, 8, 12, 64):
        for p in (1, 2, 4, 8):
            for n_chunks in (None, 0, 1, p, 2 * p, 3 * p + 1, 100):
                assert tr.subchunks_per_peer(r, p, n_chunks) == ref_tr.subchunks_per_peer(r, p, n_chunks)
                assert comm_model.effective_chunks(p, n_chunks) == ref_cm.effective_chunks(p, n_chunks)


# ---------------------------------------------------------------------------
# transpose_then_fft vs numpy.fft
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_transpose_then_fft_matches_numpy(p, impl):
    mesh = SimMesh(p, device="cpu")
    x = _c64(20 + p, (2, 8 * p, 4 * p))  # (batch, R, C); the FFT runs over R
    for name in ("alltoall", "scatter", "pairwise_xor", "bisection"):
        if not backends.get(name).supports(p):
            continue
        for fused in (False, True):
            for n_chunks in (None, 2 * p):
                for inverse in (False, True):
                    got = _gather_cols(tr.transpose_then_fft(
                        _blocks(x, p), mesh, "model", strategy=name, impl=impl,
                        fused=fused, n_chunks=n_chunks, inverse=inverse))
                    xt = np.swapaxes(x, -1, -2)
                    exp = np.fft.ifft(xt, axis=-1) if inverse else np.fft.fft(xt, axis=-1)
                    err = np.abs(got - exp).max() / np.abs(exp).max()
                    assert err < 5e-5, (name, fused, n_chunks, inverse, err)


def test_transpose_then_fft_c128_keeps_double_precision():
    p = 4
    mesh = SimMesh(p, device="cpu")
    x = _c64(5, (16, 8)).astype(np.complex128)
    got = _gather_cols(tr.transpose_then_fft(
        _blocks(x, p), mesh, "model", strategy="scatter", fused=True))
    exp = np.fft.fft(x.T, axis=-1)
    assert got.dtype == np.complex128
    assert np.abs(got - exp).max() / np.abs(exp).max() < 1e-12


# ---------------------------------------------------------------------------
# the fused exchange's accumulate: chunk_fns with a keyword-only out=
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("name", ["scatter", "pairwise_xor"])
def test_fused_exchange_accumulates_through_the_pack_wrapper(monkeypatch, name, q):
    """transpose_then_fft(fused=True, impl="kernel") equals numpy's FFT
    with one fresh pack per rank (its own chunk, whole) and every
    arriving sub-chunk added into its slot of that rank's accumulator
    through out=: no per-arrival fresh tensor and no torch.cat."""
    from repro_torch.kernels import fft_stage, ref

    p = 4
    fresh, slots, cats = [], [], []

    def pack(chunk, m, *, out=None):
        if out is None:  # the kernel's fresh result is contiguous
            fresh.append(ref.chunk_twiddle_pack_ref(chunk, m).contiguous())
            return fresh[-1]
        slots.append(out)
        assert ref.chunk_twiddle_pack_ref(chunk, m, out=out) is out
        return out

    def cat(*args, **kwargs):
        cats.append(args)
        return real_cat(*args, **kwargs)

    real_cat = torch.cat
    monkeypatch.setattr(fft_stage, "chunk_twiddle_pack_c64", pack)
    monkeypatch.setattr(torch, "cat", cat)
    mesh = SimMesh(p, device="cpu")
    x = _c64(60 + q, (2, 8 * p, 4 * p))  # (batch, R, C); r = 8 rows a rank
    ys = tr.transpose_then_fft(_blocks(x, p), mesh, "model", strategy=name, impl="kernel", fused=True,
                               n_chunks=q * p)
    monkeypatch.setattr(torch, "cat", real_cat)
    got = _gather_cols(ys)
    exp = np.fft.fft(np.swapaxes(x, -1, -2), axis=-1)
    assert np.abs(got - exp).max() / np.abs(exp).max() < 5e-5
    r = 8
    assert len(fresh) == p and all(f.shape == (2, 4, p, r) for f in fresh)
    assert len(slots) == p * (p - 1) * q and all(s.shape == (2, 4, p, r // q) for s in slots)
    storages = {f.untyped_storage().data_ptr() for f in fresh}
    assert {s.untyped_storage().data_ptr() for s in slots} == storages  # views of the accumulators
    assert cats == []


@pytest.mark.parametrize("q", [1, 2])
@pytest.mark.parametrize("name", ["scatter", "pairwise_xor"])
def test_accumulating_reduce_is_bit_identical_to_fresh_plus_add(name, q):
    """On the CPU the out= path sums the same terms in the same order as
    the fresh-result-plus-add_ path a plain chunk_fn takes."""
    from repro_torch.kernels import ref

    p = 4
    mesh = SimMesh(p, device="cpu")
    xs = _blocks(_c64(70 + q, (2, 8 * p, 4 * p)), p)
    w = torch.from_numpy(_c64(72, (p, p, 8)))  # per source: an m of (p, r)

    def acc_fn(chunk, src, offset, *, out=None):
        return ref.chunk_twiddle_pack_ref(chunk, w[src][:, offset : offset + chunk.shape[-2]], out=out)

    def fresh_fn(chunk, src, offset):
        return ref.chunk_twiddle_pack_ref(chunk, w[src][:, offset : offset + chunk.shape[-2]])

    backend = backends.get(name)
    got = backend.stream_reduce(xs, mesh, "model", acc_fn, n_chunks=q * p)
    exp = backend.stream_reduce(xs, mesh, "model", fresh_fn, n_chunks=q * p)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)


def test_chunk_fns_without_a_keyword_only_out_keep_fresh_results():
    """A caller's chunk_fn without a keyword-only out -- plain, with a
    positional out, or with **kwargs -- is handed every sub-chunk, its
    own chunk's too, never an out=, and its fresh results are summed."""
    p, q = 4, 2
    mesh = SimMesh(p, device="cpu")
    x = _c64(80, (4 * p, 4 * p))
    xs = _blocks(x, p)
    r, c = 4, 4
    blocks = x.reshape(p, r, p * c)
    for fn_kind in ("plain", "positional out", "kwargs"):
        seen = []

        def body(chunk, src, offset, kw):
            assert not kw
            seen.append((src, offset, chunk.shape[-2]))
            return chunk.transpose(-1, -2) * (src + 1)

        fns = {
            "plain": lambda chunk, src, offset: body(chunk, src, offset, {}),
            "positional out": lambda chunk, src, offset, out=None: body(chunk, src, offset, {} if out is None else {"out": out}),
            "kwargs": lambda chunk, src, offset, **kw: body(chunk, src, offset, kw),
        }
        assert not tr._chunk_fn_accumulates(fns[fn_kind])
        got = backends.get("scatter").stream_reduce(xs, mesh, "model", fns[fn_kind], n_chunks=q * p)
        assert len(seen) == p * p * q and all(rows == r // q for _, _, rows in seen)
        for me in range(p):
            exp = sum((s + 1) * blocks[s][:, me * c : (me + 1) * c].T for s in range(p))
            np.testing.assert_allclose(got[me].numpy(), exp, rtol=1e-6, atol=1e-6)
    assert tr._chunk_fn_accumulates(lambda chunk, src, offset, *, out=None: chunk)
    assert not tr._chunk_fn_accumulates(max)  # no signature: a plain chunk_fn


# ---------------------------------------------------------------------------
# SimMesh primitives
# ---------------------------------------------------------------------------


def test_ppermute_copies_into_fresh_receive_tensors():
    mesh = SimMesh(4, device="cpu")
    pieces = [torch.full((2, 3), float(i)) for i in range(4)]
    out = mesh.ppermute(pieces, [(i, (i + 1) % 4) for i in range(4)])
    for dst in range(4):
        assert torch.equal(out[dst], pieces[(dst - 1) % 4])
        assert all(out[dst].data_ptr() != pc.data_ptr() for pc in pieces)
    partial = mesh.ppermute(pieces, [(0, 1)])
    assert torch.equal(partial[1], pieces[0]) and not partial[0].any() and not partial[2].any()


@pytest.mark.parametrize("name", ["scatter", "pairwise_xor"])
def test_streaming_exchanges_post_every_message_before_the_first_callback(name):
    """The simulated mesh's messages are posted as the process-group
    mesh's are (all before any chunk callback) and copied when waited
    on; each callback sees how many are still in flight."""
    p, q = 4, 2
    mesh = SimMesh(p, device="cpu")
    xs = _blocks(_c64(50, (4 * p, 4 * p)), p)
    for run in (
        lambda fn: tr.distributed_transpose(xs, mesh, "model", strategy=name, chunk_fn=fn, n_chunks=q * p),
        lambda fn: backends.get(name).stream_reduce(xs, mesh, "model", fn, n_chunks=q * p),
    ):
        seen = []

        def fn(chunk, src, offset):
            seen.append((mesh.axis_index("model"), src, mesh.in_flight))
            return chunk

        run(fn)
        own = [(me, me, (p - 1) * q) for me in range(p) for _ in range(q)]
        assert sorted(seen[: p * q]) == own  # the own chunks first, every message posted
        assert [n for _, _, n in seen[p * q :]] == [n for n in range((p - 1) * q - 1, -1, -1) for _ in range(p)]
        assert mesh.in_flight == 0


def test_pending_message_is_waited_once():
    mesh = SimMesh(2, device="cpu")
    pending = mesh.ppermute_start([torch.ones(2), torch.zeros(2)], [(0, 1), (1, 0)])
    assert mesh.in_flight == 1
    got = pending.wait()
    assert torch.equal(got[0], torch.zeros(2)) and torch.equal(got[1], torch.ones(2)) and mesh.in_flight == 0
    with pytest.raises(RuntimeError, match="already waited on"):
        pending.wait()


def test_all_to_all_split_gather_and_axis_index():
    mesh = SimMesh(4, device="cpu")
    x = torch.arange(4 * 8).reshape(8, 4)
    blocks = mesh.split(x, ("model", None))
    assert [b.shape for b in blocks] == [(2, 4)] * 4
    assert torch.equal(mesh.gather(blocks, ("model", None)), x)
    out = mesh.all_to_all(blocks, split_axis=1, concat_axis=0)
    for dst in range(4):
        assert torch.equal(out[dst], x[:, dst : dst + 1])
    with pytest.raises(RuntimeError, match="per-rank code"):
        mesh.axis_index("model")
    with mesh.running(2):
        assert mesh.axis_index("model") == 2
    with pytest.raises(ValueError, match="not 'rows'"):
        mesh.axis_size("rows")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert SimMesh(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SimMesh(2)


def test_entry_points_run_on_the_mesh_device_not_the_inputs():
    """A global array on another device is moved to the mesh's device
    before any stage runs (here a CPU tensor onto a meta mesh, so the
    result's device shows where it was computed); blocks handed straight
    to an exchange on the wrong device are refused."""
    from repro_torch.core import FFTConfig, fft2, fft3, plan_fft

    meta = SimMesh(2, device="meta")
    x = torch.from_numpy(_c64(40, (8, 8)))
    assert fft2(x, meta, "model").device.type == "meta"
    assert fft3(torch.from_numpy(_c64(41, (4, 4, 4))), meta, "model").device.type == "meta"
    assert plan_fft((8, 8), meta, backend="alltoall").execute(x).device.type == "meta"
    assert fft2(x, meta, "model", FFTConfig(strategy="xla_auto")).device.type == "meta"
    with pytest.raises(ValueError, match="mesh's ranks are on meta"):
        tr.distributed_transpose(_blocks(x.numpy(), 2), meta, "model", strategy="scatter")
    cpu = SimMesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh's ranks are on cpu"):
        cpu.ppermute([t.to("meta") for t in _blocks(x.numpy(), 2)], [(0, 1), (1, 0)])


# ---------------------------------------------------------------------------
# Registry + cost model (mirrors tests/test_backends.py against the port)
# ---------------------------------------------------------------------------


def test_registry_contains_all_strategies():
    names = set(backends.available())
    assert PAPER_STRATEGIES <= names
    assert "pairwise_xor" in names
    assert tuple(sorted(names)) == backends.available()
    from repro.core import backends as ref_backends

    assert backends.available() == ref_backends.available()
    for n in backends.available():
        mine, theirs = backends.get(n), ref_backends.get(n)
        assert (mine.kind, mine.supports_chunk_fn) == (theirs.kind, theirs.supports_chunk_fn)
        assert [mine.supports(p) for p in range(1, 17)] == [theirs.supports(p) for p in range(1, 17)]


def test_unknown_backend_lists_registry():
    with pytest.raises(ValueError) as ei:
        backends.get("lci")
    for name in backends.available():
        assert name in str(ei.value)


def test_duplicate_registration_rejected():
    class Dup(backends.CollectiveBackend):
        name = "alltoall"

    with pytest.raises(ValueError, match="already registered"):
        backends.register(Dup)


def test_cost_delegates_to_comm_model():
    m, p = 8 * 2**20, 16
    assert backends.get("alltoall").cost(m, p) == comm_model.t_alltoall(m, p)
    assert backends.get("scatter").cost(m, p) == comm_model.t_scatter_ring(m, p)
    assert backends.get("bisection").cost(m, p) == comm_model.t_bisection(m, p)
    assert backends.get("pairwise_xor").cost(m, p) == comm_model.t_pairwise(m, p)
    assert backends.get("xla_auto").cost(m, p) == comm_model.t_alltoall(m, p)


def test_costs_equal_reference_under_same_params():
    from repro.core import backends as ref_backends
    from repro.core import comm_model as ref_cm

    for alpha, beta in ((1e-6, 200e9), (1e-5, 450e9)):
        mine, theirs = comm_model.CommParams(alpha, beta), ref_cm.CommParams(alpha, beta)
        for name in backends.available():
            for p in (1, 2, 4, 8):
                if not backends.get(name).supports(p):
                    continue
                for cc, nc, fused in ((0.0, None, True), (2e-5, 16, True), (2e-5, None, False)):
                    a = backends.get(name).cost(3e6, p, mine, cc, n_chunks=nc, fused=fused)
                    b = ref_backends.get(name).cost(3e6, p, theirs, cc, n_chunks=nc, fused=fused)
                    assert a == b, (name, p, cc, nc, fused)


def test_default_params_are_h100_data_sheet_rates():
    prm = comm_model.CommParams()
    assert prm.beta_bytes_s == 450e9 and comm_model.HBM_BW == 3.35e12


def test_cheapest_is_cost_argmin():
    m, p = 4 * 2**20, 8
    pick = backends.cheapest(m, p)
    costs = {n: backends.get(n).cost(m, p) for n in backends.supporting(p)}
    assert costs[pick] == min(costs.values())


def test_pairwise_cost_charges_chunk_compute():
    m, p = 1 * 2**20, 8
    prm = comm_model.CommParams()
    per_chunk = prm.alpha_s + (m / p) / prm.beta_bytes_s
    heavy = 10 * per_chunk
    assert backends.get("pairwise_xor").cost(m, p, prm, heavy) == backends.get("scatter").cost(m, p, prm, heavy)
    assert backends.get("pairwise_xor").cost(m, p, prm, heavy) > backends.get("pairwise_xor").cost(m, p, prm) + heavy
    assert backends.get("scatter").cost(m, p, prm, heavy) < backends.get("alltoall").cost(m, p, prm, heavy)
    assert backends.cheapest(m, p, prm, chunk_compute_s=heavy) in ("scatter", "pairwise_xor")


def test_pairwise_xor_power_of_two_only():
    b = backends.get("pairwise_xor")
    assert b.supports(1) and b.supports(2) and b.supports(8)
    assert not b.supports(3) and not b.supports(6)
    assert backends.cheapest(1024, 6) in backends.available()


def test_global_backend_has_no_transpose():
    with pytest.raises(NotImplementedError):
        backends.get("xla_auto").transpose(None, None, "model")
    with pytest.raises(NotImplementedError, match="not chunk-streaming"):
        backends.get("alltoall").stream_reduce(None, None, "model", None)


def test_scatter_exposed_compute_charged():
    m, p = 1 * 2**20, 8
    prm = comm_model.CommParams()
    per_chunk = prm.alpha_s + (m / p) / prm.beta_bytes_s
    heavy = 10 * per_chunk
    t = comm_model.t_scatter_ring(m, p, prm, chunk_compute_s=heavy)
    base = comm_model.t_scatter_ring(m, p, prm)
    assert abs(t - (base + heavy + (heavy - per_chunk) * (p - 1))) < 1e-15
    light = 0.5 * per_chunk
    assert abs(comm_model.t_scatter_ring(m, p, prm, light) - (base + light)) < 1e-15


def test_pairwise_model_matches_ring_bytes():
    m, p = 2 * 2**20, 8
    assert comm_model.t_pairwise(m, p) == comm_model.t_scatter_ring(m, p)
    assert comm_model.t_pairwise(m, 1) == 0.0
