"""Shared layer primitives: norms, RoPE, embeddings, initializers, ported
from ``repro.models.common``.

Functional style, as there: ``init_*`` returns ``(params, specs)`` where
``specs`` mirrors the param tree with tuples of *logical* sharding axis
names (``repro_torch.core.sharding`` resolves them against a mesh);
``apply_*`` are plain functions on tensors. Initializers take an
explicit ``torch.Generator`` and ``device``: they cannot reproduce
JAX's random bits, so parity with the reference comes from its weights
(``models.model.params_from_numpy``), and these are held only in their
statistics.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.mesh import note_backward

Params = dict
Specs = dict
#: a layer's activations: one (B, S, d) tensor the same on every rank, or
#: under Megatron sequence parallelism one (B, S/P, d) block per local rank
Acts = Union[torch.Tensor, List[torch.Tensor]]


#: The dry run's cap on the trips of the loops over positions
#: (``launch.dryrun.executed``), by loop name: "kv" (the online softmax's
#: KV chunks, forward and backward), "mamba" (Mamba's chunks), "mlstm"
#: (the mLSTM's chunks), "slstm" (the sLSTM's time steps). A loop named
#: here runs that many of its trips -- its first ones and its last -- and
#: stands in for the others with uninitialised outputs of their shapes
#: (:func:`stand_ins`): the dry run traces at two caps and extends the
#: difference to the loop's own count. A cap applies to tensors on the
#: ``meta`` device alone (a trace): a capped loop over real tensors
#: raises. Empty (as everywhere else): every trip runs.
#: :data:`TRIPS_SEEN` records each named loop's counts.
TRIP_CAPS: Dict[str, int] = {}
TRIPS_SEEN: Dict[str, set] = {}


def trips(name: str, n: int, on: torch.Tensor) -> Tuple[List[int], int]:
    """(the trips of loop ``name``, of ``n``, over tensors on ``on``'s
    device, to run, in order; how many it skips): all of them, or under
    :data:`TRIP_CAPS` the first ``cap - 1`` and the last, the skipped ones
    lying between those two. Raises where a cap is set and ``on`` is not
    on the ``meta`` device: the skipped trips' outputs would be
    uninitialised memory."""
    cap = TRIP_CAPS.get(name)
    if cap is None:
        return list(range(n)), 0
    if not on.is_meta:
        raise RuntimeError(f"the loop {name!r} is capped at {cap} trips (models.common.TRIP_CAPS) over tensors "
                           f"on {on.device}: a cap is for a trace on the meta device alone")
    TRIPS_SEEN.setdefault(name, set()).add(n)
    if n <= cap:
        return list(range(n)), 0
    return list(range(cap - 1)) + [n - 1], n - cap


def stand_ins(like: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``n`` uninitialised tensors of ``like``'s shape and dtype: the
    outputs of the trips a capped loop skips (:func:`trips`)."""
    return list(torch.empty((n,) + tuple(like.shape), dtype=like.dtype, device=like.device).unbind(0))


def _std(shape, scale: float) -> float:
    return scale / math.sqrt(shape[0] if len(shape) > 1 else 1)


def _unit_draw(shape, std: float, generator: torch.Generator, device) -> torch.Tensor:
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if out.is_meta:  # a shape without values: nothing to draw
        return out
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return out.mul_(std)


def trunc_normal(shape, scale: float, *, generator: torch.Generator, device,
                 dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal init with fan-in scaling (MaxText default): std =
    scale / sqrt(shape[0]) (1 for a vector), truncated at +-3 std."""
    return _unit_draw(shape, _std(shape, scale), generator, device).to(dtype)


def dense_init(shape, *, generator: torch.Generator, device, scale: float = 1.0) -> torch.Tensor:
    return trunc_normal(shape, scale, generator=generator, device=device)


class Deferred(NamedTuple):
    """A ``dense_init`` draw of ``shape`` made later, one slice of the
    leading axis at a time, in float32 straight into the tensor that keeps
    it (of any float dtype): a DeepSeek-V3 MoE layer's experts are 46 GB
    in float32, so ``Model.init`` never makes them whole."""

    shape: Tuple[int, ...]
    scale: float = 1.0

    def fill(self, out: torch.Tensor, generator: torch.Generator, first: int = 0,
             cut: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
        """Draw all ``shape[0]`` slices in order and write slices ``first``
        .. ``first + len(out)`` into ``out`` (a rank's block of the
        experts: the same values as the whole draw's, whatever it keeps),
        each through ``cut`` where the rank keeps a block of a slice's
        dims too (FSDP's block of ``d_model``). On the ``meta`` device
        ``out`` holds no values: nothing is drawn."""
        if out.is_meta:
            return out
        std = _std(self.shape, self.scale)
        for j in range(self.shape[0]):
            draw = _unit_draw(self.shape[1:], std, generator, out.device)
            if first <= j < first + out.shape[0]:
                out[j - first].copy_(draw if cut is None else cut(draw))
        return out

    def draw(self, generator: torch.Generator, device) -> torch.Tensor:
        return self.fill(torch.empty(self.shape, device=device), generator)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(d: int, kind: str, device) -> Tuple[Params, Specs]:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), device=device)}, {"scale": (None,)}
    if kind == "layernorm":
        return (
            {"scale": torch.zeros((d,), device=device), "bias": torch.zeros((d,), device=device)},
            {"scale": (None,), "bias": (None,)},
        )
    raise ValueError(kind)


def apply_norm(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """The ``(1 + scale)`` form, in float32; layernorm's variance is the
    population one (``jnp.var``)."""
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps) * (1.0 + p["scale"]) + p["bias"]
    return out.to(x.dtype)


def init_groupnorm(heads: int, d: int, device) -> Tuple[Params, Specs]:
    """Per-head group norm (xLSTM blocks)."""
    return {"scale": torch.zeros((d,), device=device)}, {"scale": (None,)}


def apply_groupnorm(p: Params, x: torch.Tensor, heads: int, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., H, dh) normalized per head."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out.reshape(out.shape[:-2] + (-1,)) * (1.0 + p["scale"])
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S) integer.

    ``fraction`` < 1 rotates only the leading dims (nemotron partial rope).
    """
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0 or theta <= 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    # positions (..., S) -> angles (..., S, 1, half), broadcasting over heads
    ang = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < d else out


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (seq, d), built in
    float64 with numpy as the reference builds them."""
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(generator: torch.Generator, vocab: int, d: int, tie: bool, device) -> Tuple[Params, Specs]:
    p = {"table": trunc_normal((vocab, d), 1.0, generator=generator, device=device)}
    s = {"table": ("vocab", "fsdp")}
    if not tie:
        p["unembed"] = trunc_normal((d, vocab), 1.0, generator=generator, device=device)
        s["unembed"] = ("fsdp", "vocab")
    return p, s


def embed_tokens(p: Params, tokens: torch.Tensor, dtype, tp: Optional["TP"] = None,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """Look the tokens up. Vocab-parallel (``tp`` splits the ``vocab``
    rows): each rank looks up in its rows, zeroes the tokens outside
    them, and one psum adds the ranks' lookups -- one of them nonzero, so
    the sum is the one-rank lookup bit for bit."""
    if tp is None or not tp.splits(vocab):
        return p["table"].to(dtype)[tokens.long()]
    n = vocab // tp.p
    parts = []
    for c in tp.ranks:
        local = tokens.long() - c * n
        inside = (local >= 0) & (local < n)
        rows = tp.block(p["table"], 0, c, vocab).to(dtype)[local.clamp(0, n - 1)]
        parts.append(torch.where(inside[..., None], rows, torch.zeros((), dtype=dtype, device=rows.device)))
    return tp.psum(parts)


def unembed(p: Params, x: torch.Tensor, tie: bool, tp: Optional["TP"] = None,
            vocab: Optional[int] = None) -> List[torch.Tensor]:
    """Logits, one (..., V/P) block per local rank where ``tp`` splits the
    vocabulary (the reference's vocab-sharded constraint), else one
    (..., V). A tied table (gemma2) gives the same rows' block."""
    if tp is None or not tp.splits(vocab):
        w = p["table"].T if tie else p["unembed"]
        return [x @ w.to(x.dtype)]
    x = tp.vary(x)  # the same on every rank, into each rank's vocabulary block
    if tie:
        return [x @ tp.block(p["table"], 0, c, vocab).T.to(x.dtype) for c in tp.ranks]
    return [x @ tp.block(p["unembed"], 1, c, vocab).to(x.dtype) for c in tp.ranks]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Activations, op by op as the reference's XLA rounds them
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference lowers it, x * (1 / (1 + exp(-x))),
    each op rounded to x's dtype: in bfloat16 bitwise the reference's
    (``F.silu`` rounds once and differs in a third of the values)."""
    return x * (1 / (1 + torch.exp(-x)))


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` (a Python float: multiplying by it
    rounds once, as by the reference's constant in that dtype). A host
    computation, made once a value and dtype: no op of it reaches the
    step's device."""
    return torch.tensor(value, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh form op by op, its constants rounded to x's
    dtype: in bfloat16 bitwise the reference's."""
    c, k = _rounded(math.sqrt(2 / math.pi), x.dtype), _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))



# ---------------------------------------------------------------------------
# Tensor parallelism over the mesh's ``model`` axis
# ---------------------------------------------------------------------------


class SeqCut(NamedTuple):
    """A serving cache's sequence in ``blocks`` equal blocks over the
    mesh's ``data`` axis (:meth:`TP.with_kv_seq`)."""

    ring: Any  # the 1-D view over ``data`` its partial softmaxes combine over
    coords: List[int]  # the ``data`` coordinates this process runs
    blocks: int  # the ``data`` axis's size
    holds_block: bool  # the process holds its own block (else the whole cache, a block a view)


def seq_blocks(data: int, positions: int) -> int:
    """The blocks over a ``data`` axis of ``data`` ranks that a serving
    cache of ``positions`` positions lies in when its sequence is cut
    there (``seq_shard``): one a rank where they divide the positions,
    else 1 (the reference's ``sanitize_spec`` drops an axis that does not
    divide its dim)."""
    return data if positions % data == 0 else 1


class TP:
    """The ``model`` axis as the layers see it (Megatron-style tensor
    parallelism: heads, ``d_ff`` and the vocabulary over the axis).

    ``ranks`` are the ``model`` coordinates this process computes: all P
    on a ``SimMesh`` (lock step; one ring serves every ``data``
    coordinate: a ``SimMesh`` holds every weight whole), its own on a
    ``ProcessGroupMesh``. A layer computes one part per coordinate from
    the rank's blocks of its weights (:meth:`block`: a view of the whole
    leaf on a ``SimMesh``, the leaf itself where the process holds its
    block) and sums them with :meth:`psum`. Without a mesh, or on a
    ``model`` axis of one rank, ``ranks`` is ``[0]`` and every block is the
    whole leaf: the one-rank model, op for op.

    Training over a ``ProcessGroupMesh`` (one rank a process): each rank's
    graph holds only its own part, and every rank computes the same loss
    from activations that are the same on every rank after each
    collective. So :meth:`psum` and :meth:`gather` take Megatron's
    backward passes (``core.mesh``), and :meth:`vary` -- Megatron's "f" --
    marks each place where a tensor that is the same on every rank
    enters compute that differs by rank: a product with the rank's block
    of a weight (:meth:`col` with ``split``), the rank's slice of it
    (:meth:`scatter_seq`, the context partition's queries, a Mamba
    rank's channels of ``dt``), or a leaf kept whole that meets the
    rank's own activations (``block(..., vary=True)``, the norms on
    sequence blocks, :meth:`norm`). Its backward sums the ranks'
    gradients. On a ``SimMesh`` all ranks lie in one autograd graph and
    :meth:`vary` does nothing. Over processes with ``('pod', 'data')``
    axes of several ranks, the model hands the layers its ``model`` ring
    (``mesh``) and the weights already gathered whole over those axes
    (FSDP, ``models.model``); ``batch`` is then ``(the whole mesh, those
    axes)``: each process computes on its own rows of the batch, and the
    MoE ring's aux reads the other rows' groups through it.

    ``seq`` is the layout of the activations between the layers: False,
    one tensor the same on every rank (the reference's prefill and
    decode); True, Megatron sequence parallelism (the reference's
    ``seq_parallel`` residual constraint in ``Model.hidden``): each
    rank's (B, S/P, d) block, which a column-parallel projection gathers
    with PR 18's ring all-gather, multiplying each arriving chunk
    (:meth:`col`), and a row-parallel output returns to with the ring
    reduce-scatter (:meth:`reduce`).

    ``kv_seq`` (:meth:`with_kv_seq`): a serving cache whose sequence lies
    in blocks over the mesh's ``data`` axis, or None."""

    def __init__(self, mesh=None, seq: bool = False, batch=None):
        self.mesh = mesh
        self.batch = batch
        self.p = mesh.shape.get("model", 1) if mesh is not None else 1
        self.ring = mesh.rings("model")[0][0] if self.p > 1 else None  # a 1-D view over ``model``
        self.ranks: List[int] = self.ring.local_ranks() if self.p > 1 else [0]
        self.holds_block = mesh is not None and mesh.caller_holds_block
        self.seq = seq and self.p > 1
        self.kv_seq: Optional[SeqCut] = None

    def with_seq(self, seq: bool) -> "TP":
        """The same axis with the activations in the other layout."""
        out = TP.__new__(TP)
        out.__dict__.update(self.__dict__, seq=seq and self.p > 1)
        return out

    def with_kv_seq(self, on: bool, positions: int) -> "TP":
        """The same axis serving a cache of ``positions`` positions whose
        sequence lies in blocks over the mesh's ``data`` axis, where ``on``
        (``Model.init_decode_state(seq_shard=True)``, the reference's
        ``seq_shard``) and :func:`seq_blocks` gives several; else no such
        cache."""
        full = self.batch[0] if self.batch is not None else self.mesh
        n = seq_blocks(full.shape.get("data", 1), positions) if on and full is not None else 1
        cut = None
        if n > 1:
            ring = full.rings("data")[0][0]
            held = full.caller_holds_block
            cut = SeqCut(ring, [full.axis_index("data")] if held else ring.local_ranks(), n, held)
        out = TP.__new__(TP)
        out.__dict__.update(self.__dict__, kv_seq=cut)
        return out

    def splits(self, units: Optional[int]) -> bool:
        """Whether a dim of ``units`` whole units is split over the axis
        (``core.sharding.placement``'s rule)."""
        return self.p > 1 and units is not None and units % self.p == 0

    def block(self, w: torch.Tensor, dim: int, c: int, full: int, units: Optional[int] = None, *,
              vary: bool = False) -> torch.Tensor:
        """Coordinate ``c``'s block of a leaf whose size along ``dim`` is
        ``full`` (``units`` whole units, default ``full``): the leaf where
        the dim is not split, else its slice -- a view on a ``SimMesh``,
        the leaf itself where the process holds its block. ``vary``: the
        coordinate's compute differs by rank (its products are its part,
        or the activations are sequence blocks), so a leaf kept whole
        enters through :meth:`vary`."""
        if not self.splits(full if units is None else units):
            return self.vary(w, vary, c)
        n = full // self.p
        if self.holds_block and w.shape[dim] == n:
            return w
        if not self.holds_block and w.shape[dim] == full:
            return w.narrow(dim, c * n, n)
        raise ValueError(f"a leaf of shape {tuple(w.shape)} holds {w.shape[dim]} of dim {dim}'s {full} on "
                         f"{self.mesh}: build the params for this mesh (Model.init, params_from_numpy(mesh=, "
                         "specs=, cfg=))")

    def parts(self, w: torch.Tensor, dim: int, c: int, full: int, parts: int) -> List[torch.Tensor]:
        """Coordinate ``c``'s blocks of a leaf whose dim ``dim`` (``full``
        long) packs ``parts`` equal parts (``[x | z]``): one view a part,
        of the whole part where the part's width is not split, else of
        its c-th block (``core.sharding.block(parts=)``: a process that
        holds its block holds the parts' blocks side by side)."""
        width = full // parts
        if not self.splits(width):
            return list(torch.split(w, width, dim))
        n = width // self.p
        if self.holds_block and w.shape[dim] == parts * n:
            return list(torch.split(w, n, dim))
        if self.holds_block or w.shape[dim] != full:
            raise ValueError(f"a leaf of shape {tuple(w.shape)} holds {w.shape[dim]} of dim {dim}'s {full} "
                             f"({parts} parts) on {self.mesh}: build the params for this mesh")
        return [w.narrow(dim, j * width + c * n, n) for j in range(parts)]

    # -- collectives over the axis ---------------------------------------------
    def vary(self, t: torch.Tensor, when: bool = True, c: Optional[int] = None) -> torch.Tensor:
        """``t``, the same on every rank, entering compute that differs by
        rank (``mesh.pvary``, Megatron's "f"): the forward is the identity;
        on a ``ProcessGroupMesh`` the backward sums the ranks' gradients
        over the axis. ``t`` itself where not ``when``, on one rank, or on
        a ``SimMesh`` (one autograd graph holds every rank's use), which
        counts the all-reduce a process-group rank's backward issues
        (``core.mesh.note_backward``) -- once for a call made for every
        local coordinate, or for coordinate ``c`` only where it is the
        first local one (a call made once a coordinate)."""
        if not when or self.p == 1:
            return t
        if not self.holds_block:
            if c is None or c == self.ranks[0]:
                note_backward(self.ring, "all-reduce", t)
            return t
        return self.ring.pvary([t], "model")[0]

    def vary_tree(self, p: Params, when: bool = True) -> Params:
        """:meth:`vary` on every leaf of a dict of leaves (a norm's)."""
        return {k: self.vary(v, when) for k, v in p.items()}

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of the local ranks' parts over the axis (``lax.psum``),
        the same tensor on every rank."""
        return parts[0] if self.p == 1 else self.ring.psum(list(parts), "model")[0]

    def psum_cat(self, parts: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        """Each local rank's list of partial sums (one dtype, the same
        leading dims) -> the sums, by one psum of them side by side along
        the last dim; on one rank the list as it is."""
        if self.p == 1:
            return list(parts[0])
        sizes = [a.shape[-1] for a in parts[0]]
        return list(torch.split(self.psum([torch.cat(list(ps), -1) for ps in parts]), sizes, -1))

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The local ranks' blocks along ``dim`` -> the whole tensor, on
        every rank (an all-gather)."""
        if self.p == 1:
            return parts[0]
        dim %= parts[0].ndim
        return self.ring.gather(list(parts), (None,) * dim + ("model",) + (None,) * (parts[0].ndim - dim - 1))

    def all_to_all(self, parts: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> List[torch.Tensor]:
        return self.ring.all_to_all(list(parts), split_axis, concat_axis)

    # -- the activations' layout -----------------------------------------------
    def each(self, fn: Callable, *xs: Acts) -> Acts:
        """``fn`` elementwise over activations in either layout."""
        return [fn(*a) for a in zip(*xs)] if self.seq else fn(*xs)

    def norm(self, p: Optional[Params], x: Acts, kind: str) -> Acts:
        """``apply_norm(p, ., kind)`` over activations in either layout
        (``x`` as it is where ``p`` is None). On sequence blocks each rank
        normalizes its own rows, so its scale (kept whole) enters through
        :meth:`vary`: the scale's gradient is summed over the axis."""
        if p is None:
            return x
        p = self.vary_tree(p, self.seq)
        return self.each(lambda a: apply_norm(p, a, kind), x)

    def scatter_seq(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A replicated (B, S, d) tensor -> the local ranks' sequence
        blocks (through :meth:`vary`: each rank keeps its own rows)."""
        x = self.vary(x)
        s = x.shape[1] // self.p
        return [x.narrow(1, c * s, s) for c in self.ranks]

    def whole(self, x: Acts) -> torch.Tensor:
        """Activations in either layout -> the whole (B, S, d) tensor."""
        return self.gather(x, 1) if self.seq else x

    def owners(self, split: bool) -> List[int]:
        """The coordinates whose outputs a sublayer computes: every local
        one where it is split over the axis or the activations are
        sequence blocks; else the first (each rank's would be the same
        whole output, and :meth:`reduce` keeps one)."""
        return self.ranks if split or self.seq else self.ranks[:1]

    def col(self, x: Acts, ws_of: Callable[[int], Sequence[torch.Tensor]],
            coords: Optional[Sequence[int]] = None, *, split: bool = False) -> List[List[torch.Tensor]]:
        """Column-parallel products over the whole sequence: for each
        coordinate ``c`` of ``coords`` (default every local one),
        ``[x @ w for w in ws_of(c)]`` (the weights cast to x's dtype).
        Replicated ``x``: a weight that is the same tensor for every
        coordinate (a leaf kept whole) is multiplied once; with ``split``
        (``ws_of`` gives the coordinates' blocks: the products are each
        rank's part) ``x`` enters through :meth:`vary`. A leaf kept whole
        among split ones, or under sequence blocks, is the caller's to
        pass through :meth:`vary` (``block(..., vary=True)``).
        Sequence blocks: one ring all-gather over the axis whose chunk
        function multiplies each arriving (B, S/P, d) chunk by the rank's
        weights and puts it at its place in the sequence (zeros elsewhere:
        the ring sums what the chunk function returns, and adding zeros
        is exact)."""
        if not self.seq:
            x = self.vary(x, split)
            done = {}

            def prod(w):
                if id(w) not in done:
                    done[id(w)] = (w, x @ w.to(x.dtype))  # the leaf held, so its id stays its own
                return done[id(w)][1]

            return [[prod(w) for w in ws_of(c)] for c in (self.ranks if coords is None else coords)]
        from repro_torch.core.overlap import ring_all_gather

        s, p, ring = x[0].shape[1], self.p, self.ring

        def chunk_fn(chunk: torch.Tensor, src: int) -> torch.Tensor:
            y = torch.cat([chunk @ w.to(chunk.dtype) for w in ws_of(ring.axis_index("model"))], dim=-1)
            return F.pad(y, (0, 0, src * s, (p - 1 - src) * s))

        with torch.no_grad():  # the widths alone: no "f" of a leaf kept whole whose gradient nothing takes
            sizes = [w.shape[-1] for w in ws_of(self.ranks[0])]
        outs = ring_all_gather(list(x), ring, "model", chunk_fn, axis=1)
        return [list(torch.split(o, sizes, dim=-1)) for o in outs]

    def reduce(self, parts: Sequence[torch.Tensor], kind: str = "partial") -> Acts:
        """The local ranks' outputs of a sublayer back to the layout.
        ``kind``: "partial", each a row-parallel partial sum over the whole
        sequence (psum; with sequence blocks a ring reduce-scatter);
        "whole", each already the whole output (a sublayer that could not
        be split: every rank computed all of it, one part per
        :meth:`owners`); "seq", each the whole
        output of the rank's sequence block (the context partition with
        every head on every rank: an all-gather, or the blocks as they
        are)."""
        if kind == "seq":
            return list(parts) if self.seq else self.gather(parts, 1)
        if not self.seq:
            return self.psum(parts) if kind == "partial" else parts[0]
        if kind == "partial":
            from repro_torch.core.overlap import ring_reduce_scatter

            return ring_reduce_scatter(list(parts), self.ring, "model", axis=1)
        s = parts[0].shape[1] // self.p
        return [o.narrow(1, c * s, s) for o, c in zip(parts, self.ranks)]


#: the one-rank model's axis: ``TP()``
SINGLE = TP()
