"""Sharded NaviX search (port of ``repro.core.distributed``).

Layout: the vector set V is split into S shards over the grid's "model"
axis, and each shard builds its OWN two-level HNSW over its slice
(shard-and-merge ANN). A search runs the batched-frontier engine
(``repro_torch.core.search_batch``) on every shard: ``Q`` is a ``[B, d]``
batch and the semimask is one shared ``[S, W_local]`` bitset or a per-lane
``[S, B, W_local]`` stack, so each lane of each shard searches its own
selection subquery's S with lane-local selectivity taken against that
shard's own slice of S. Per-shard ``[S, B, k]`` candidate lists merge into
the global top-k by one lexicographic sort on (distance, global id)
(:func:`merge_shard_topk`), with dead shards contributing ``+inf`` rows:
ties break toward the smaller global id, so the merge is deterministic and
free of shard order.

**One controller and a device grid.** The reference is single-controller
SPMD: ``shard_map`` runs in one process over a ``Mesh``. The port keeps
that model rather than a multi-process ``torch.distributed`` launcher: a
:class:`Mesh` is a 2-D grid of ``torch.device``s with axes ``("data",
"model")``, and this process steps every cell of it in turn. Shard ``s``
lives on its column's device, replicated down the data axis. A grid may
repeat a device: four shards on ``cuda:0`` is how one card runs S = 4, and
four on ``"cpu"`` is how the tests run S in {1, 2, 4}. A grid over several
cards copies each cell's lane slices to its card per call; the merge, the
lane buffers and the results live on the grid's first cell (``device``).

**The data axis.** With ``lane_shards > 1`` the B lanes split into
contiguous blocks, each stepped on its row of the grid; lanes are
independent in the engine, so a lane's result does not depend on its
block, bit for bit.

Quorum: searches carry an ``alive`` shard mask (a host bool[S]); dead
shards contribute nothing to the merge and ``quorum`` sets how many must
be alive. Padded rows: :meth:`ShardedNavix.build` pads V to a multiple of
S with copies of the last row; padded ids are excluded from every packed
semimask AND guarded in the merge path (a local id whose global id falls
at or past ``n_total`` is dropped), so a caller-built all-ones local
bitset, or the ONEHOP_A branch, which ignores the semimask, can never
surface one.

The ``*_program`` surface mirrors the reference's stepping programs (park
/ refill / step / evict / finalize) as plain callables over the per-cell
lists of ``search_batch``'s stepping API, so the serving tier's
continuous scheduler runs over a sharded index unchanged. PyTorch has no
buffer donation, so the programs take no ``donate``, and they read a
semimask's form (shared or per lane) from its rank, so no ``per_lane``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import bitset
from repro_torch.core import search_batch as sb
from repro_torch.core.build import build
from repro_torch.core.distances import normalize
from repro_torch.core.graph import HnswGraph
from repro_torch.core.heuristics import Heuristic
from repro_torch.core.navix import NavixConfig
from repro_torch.core.search import SearchParams, SearchResult, SearchStats


def _canonical(device) -> torch.device:
    """``resolve_device`` with a CUDA device's index made explicit, so two
    spellings of one card compare equal (a tensor reports ``cuda:0``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A 2-D grid of torch devices with named axes, the port's counterpart
    of ``jax.sharding.Mesh``: ``devices[i][j]`` is the cell at index ``i``
    of ``axis_names[0]`` and ``j`` of ``axis_names[1]``."""

    def __init__(self, devices: Sequence[Sequence],
                 axis_names: tuple[str, str] = ("data", "model")):
        rows = tuple(tuple(_canonical(d) for d in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
            raise ValueError(f"a mesh has two distinct axis names, got "
                             f"{axis_names!r}")
        self.devices = rows
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    def flat(self) -> tuple[torch.device, ...]:
        """Every cell's device, row-major."""
        return tuple(d for row in self.devices for d in row)

    def at(self, coords: dict[str, int]) -> torch.device:
        """The device of the cell at ``{axis: index}``."""
        return self.devices[coords[self.axis_names[0]]][
            coords[self.axis_names[1]]]

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.flat()]})")


def make_mesh(axis_shapes: tuple[int, int],
              axis_names: tuple[str, str] = ("data", "model"),
              device=None) -> Mesh:
    """A grid of ``axis_shapes`` cells (the counterpart of
    ``jax.make_mesh``). ``device`` is one device for every cell (CUDA by
    default; ``"cpu"`` for the tests) or a sequence of one device a cell,
    row-major. A CUDA cell on a host without CUDA raises."""
    rows, cols = (int(a) for a in axis_shapes)
    if rows < 1 or cols < 1:
        raise ValueError(f"mesh axes must be >= 1, got {axis_shapes}")
    if device is None or isinstance(device, (str, torch.device)):
        flat = [device] * (rows * cols)
    else:
        flat = list(device)
        if len(flat) != rows * cols:
            raise ValueError(f"{len(flat)} devices for a {rows} x {cols} "
                             f"mesh")
    return Mesh([flat[i * cols:(i + 1) * cols] for i in range(rows)],
                axis_names)


def merge_shard_topk(d: torch.Tensor, ids: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard candidates ``([S, B, L], [S, B, L])`` into the
    global top-k ``([B, k], [B, k])``.

    A lexicographic sort over the flattened shard axis keyed on (distance,
    global id): a stable sort by id, then a stable sort by distance, so
    equal distances break toward the smaller id and the merge is
    deterministic and free of shard order. Padded/dead slots carry
    ``+inf`` and sort last; any result slot left at ``+inf`` comes back
    with id ``-1``. Requires ``k <= S * L``.
    """
    s, b, l = d.shape
    if k > s * l:
        raise ValueError(f"k={k} > S*L={s * l} merge candidates")
    d2 = d.transpose(0, 1).reshape(b, s * l)
    i2 = ids.transpose(0, 1).reshape(b, s * l)
    by_id = torch.argsort(i2, dim=1, stable=True)
    d2, i2 = d2.gather(1, by_id), i2.gather(1, by_id)
    by_d = torch.argsort(d2, dim=1, stable=True)[:, :k]
    out_d = d2.gather(1, by_d)
    return out_d, torch.where(torch.isfinite(out_d), i2.gather(1, by_d), -1)


def per_shard_reference(sn: "ShardedNavix", Q, masks, params: SearchParams,
                        alive: Optional[np.ndarray] = None):
    """Host-side oracle for the sharded path.

    Runs the UNSHARDED batched engine (``search_batch.search_many``)
    independently on every shard over shard-restricted masks, applies the
    same padded-row guard, and merges with numpy ``lexsort`` under the
    same (distance, global id) rule. Returns numpy ``(dists[B, k],
    ids[B, k], stats)`` with stats summed over the alive shards.
    """
    return reference_merge(sn, shard_searches(sn, Q, masks, params),
                           params.k, alive)


def shard_searches(sn: "ShardedNavix", Q, masks, params: SearchParams):
    """The searches of :func:`per_shard_reference`: per shard, the
    unsharded engine's numpy (dists, local ids, stats) over the shard's
    slice of the per-lane ``masks`` (bool[B, n_total]). One set serves
    :func:`reference_merge` under several ``alive`` masks."""
    s, nl, n = sn.n_shards, sn.n_local, sn.n_total
    masks = np.asarray(masks, bool)
    Qp = torch.atleast_2d(sn._prep_query(Q))
    padded = np.zeros((masks.shape[0], s * nl), bool)
    padded[:, :n] = masks
    out = []
    for si in range(s):
        graph_s = sn.graphs[si]
        sel_s = bitset.from_words(
            bitset.pack_np(padded[:, si * nl:(si + 1) * nl]), graph_s.device)
        res = sb.search_many(graph_s, Qp.to(graph_s.device), sel_s, params)
        out.append((res.dists.cpu().numpy(), res.ids.cpu().numpy(),
                    [f.cpu().numpy() for f in res.stats]))
    return out


def reference_merge(sn: "ShardedNavix", searches, k: int,
                    alive: Optional[np.ndarray] = None):
    """The merge of :func:`per_shard_reference` over ``searches``
    (:func:`shard_searches`): the padded-row and liveness guard, then a
    numpy ``lexsort`` on (distance, global id) per lane."""
    s, nl, n = sn.n_shards, sn.n_local, sn.n_total
    alive = np.ones(s, bool) if alive is None else np.asarray(alive, bool)
    ds, gs = [], []
    for si, (d, ids, _) in enumerate(searches):
        ok = (ids >= 0) & (ids + si * nl < n) & alive[si]
        ds.append(np.where(ok, d, np.inf))
        gs.append(np.where(ok, ids + si * nl, -1))
    D, I = np.concatenate(ds, 1), np.concatenate(gs, 1)
    out_d = np.empty((D.shape[0], k), D.dtype)
    out_i = np.empty((D.shape[0], k), I.dtype)
    for b in range(D.shape[0]):
        order = np.lexsort((I[b], D[b]))[:k]
        out_d[b] = D[b][order]
        out_i[b] = np.where(np.isfinite(out_d[b]), I[b][order], -1)
    stat_sum = SearchStats(*(sum(x * int(a) for x, a in zip(xs, alive))
                             for xs in zip(*(st for _, _, st in searches))))
    return out_d, out_i, stat_sum


def _masked_stats_sum(stats: SearchStats, alive) -> SearchStats:
    """Sum per-shard stats ([S, B, ...] fields) over the alive shards."""
    def one(x):
        am = torch.as_tensor(np.asarray(alive, bool), dtype=torch.int32,
                             device=x.device)
        return (x * am.view((-1,) + (1,) * (x.ndim - 1))).sum(
            dim=0, dtype=torch.int32)
    return SearchStats(*(one(x) for x in stats))


def _host_alive(alive) -> np.ndarray:
    if isinstance(alive, torch.Tensor):
        alive = alive.cpu().numpy()
    return np.asarray(alive, bool)


def _host_lanes(mask) -> torch.Tensor:
    """A bool[B] lane mask as a tensor; host masks stay on the host, where
    the stepping API reads their rows without a device call."""
    if isinstance(mask, torch.Tensor):
        return mask
    return torch.from_numpy(np.array(mask, bool))


@dataclasses.dataclass
class ShardedNavix:
    mesh: Mesh
    graphs: list[HnswGraph]    # shard s on its column's device
    n_local: int               # vectors per shard (padded)
    n_total: int
    config: NavixConfig
    model_axis: str = "model"
    data_axis: str = "data"
    # set when the index is registered in a NavixDB catalog; routes search
    # through the shared program cache (repro_torch.api.plan_compile)
    program_cache: Optional[object] = None
    # memoized programs: (kind, params) -> callable
    _programs: dict = dataclasses.field(default_factory=dict, init=False,
                                        repr=False, compare=False)
    # (shard, device) -> (graph, its copy there) for grid cells off the
    # shard's own device
    _replicas: dict = dataclasses.field(default_factory=dict, init=False,
                                        repr=False, compare=False)

    def __post_init__(self):
        self.graphs = list(self.graphs)
        if len(self.graphs) != self.n_shards:
            raise ValueError(f"{len(self.graphs)} shard graphs for a mesh "
                             f"with {self.n_shards} shards on its "
                             f"{self.model_axis!r} axis")

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape[self.model_axis])

    @property
    def lane_shards(self) -> int:
        """Size of the DATA axis: how many contiguous blocks the lane
        (batch) dim of every search and stepping buffer splits into, each
        stepped on its row of the grid. Batch sizes must be a multiple of
        this."""
        return int(self.mesh.shape[self.data_axis])

    def _check_lanes(self, bsz: int) -> None:
        if bsz % self.lane_shards:
            raise ValueError(
                f"batch size {bsz} is not divisible by the data-axis "
                f"size {self.lane_shards}; pad the batch (the program "
                f"cache's bucket already rounds to a multiple)")

    @property
    def device(self) -> torch.device:
        """The grid's first cell: lane buffers, merges and results live
        here."""
        return self._cell(0, 0)

    @property
    def dim(self) -> int:
        return self.graphs[0].dim

    @property
    def n_words_local(self) -> int:
        return bitset.n_words(self.n_local)

    def _cell(self, i: int, s: int) -> torch.device:
        return self.mesh.at({self.data_axis: i, self.model_axis: s})

    def _blocks(self, bsz: int) -> list[tuple[int, int, int]]:
        """(data index, first lane, end lane) of each lane block."""
        self._check_lanes(bsz)
        bl = bsz // self.lane_shards
        return [(i, i * bl, (i + 1) * bl) for i in range(self.lane_shards)]

    def _cell_graph(self, graphs: list[HnswGraph], i: int,
                    s: int) -> HnswGraph:
        """Shard ``s``'s graph on grid cell (i, s), copied there once when
        the cell's device is not the graph's."""
        g, dev = graphs[s], self._cell(i, s)
        if g.device == dev:
            return g
        rep = self._replicas.get((s, dev))
        if rep is None or rep[0] is not g:
            rep = self._replicas[(s, dev)] = (g, g.to(dev))
        return rep[1]

    @staticmethod
    def _cell_sel(sel_bits: torch.Tensor, s: int, lo: int, hi: int,
                  dev: torch.device) -> torch.Tensor:
        """Shard ``s``'s semimask for lanes [lo, hi): its shared [W] row
        or its per-lane [hi - lo, W] block."""
        return (sel_bits[s] if sel_bits.ndim == 2
                else sel_bits[s, lo:hi]).to(dev)

    def _home(self, blocks: list[torch.Tensor]) -> torch.Tensor:
        """One shard's per-block outputs as one lane-ordered tensor on the
        grid's first cell."""
        home = self.device
        if len(blocks) == 1:
            return blocks[0].to(home)
        return torch.cat([x.to(home) for x in blocks])

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, vectors, config: NavixConfig, mesh: Mesh,
              model_axis: str = "model", data_axis: str = "data"
              ) -> "ShardedNavix":
        """Build one graph a shard over ``vectors`` (f32[n, d]), each on
        its mesh column's device."""
        vectors = np.asarray(vectors, dtype=np.float32)
        n = vectors.shape[0]
        s = int(mesh.shape[model_axis])
        n_local = -(-n // s)
        pad = s * n_local - n
        if pad:
            # pad with copies of the last row; padded ids are excluded
            # from every packed semimask AND guarded in the merge path,
            # so they can never be returned
            vectors = np.concatenate([vectors,
                                      np.repeat(vectors[-1:], pad, 0)])
        graphs = []
        for i in range(s):
            g, _ = build(vectors[i * n_local:(i + 1) * n_local],
                         config.build_params(),
                         device=mesh.at({data_axis: 0, model_axis: i}))
            graphs.append(g)
        return cls(mesh=mesh, graphs=graphs, n_local=n_local, n_total=n,
                   config=config, model_axis=model_axis,
                   data_axis=data_axis)

    # -- semimasks ------------------------------------------------------
    def shard_semimask(self, mask) -> torch.Tensor:
        """Pack a semimask for the shard layout (padded rows excluded).

        ``bool[n_total]`` -> shared int32 words ``[S, W_local]``;
        ``bool[B, n_total]`` (or a list of B masks, ``None`` entries =
        unfiltered) -> per-lane ``[S, B, W_local]``. Pre-packed uint32
        ``[S, W]`` / ``[S, B, W]`` words (or the port's int32 word
        tensors) pass through after a shape check. On ``device``.
        """
        if isinstance(mask, (list, tuple)):
            mask = np.stack([np.ones(self.n_total, bool) if m is None
                             else np.asarray(m, bool) for m in mask])
        if isinstance(mask, torch.Tensor):
            if mask.dtype == torch.int32:
                self._check_packed(tuple(mask.shape))
                return mask.to(self.device)
            mask = mask.cpu().numpy()
        mask = np.asarray(mask)
        if mask.dtype == np.uint32:
            self._check_packed(mask.shape)
            return bitset.from_words(mask, self.device)
        return bitset.from_words(self.shard_semimask_np(mask), self.device)

    def _check_packed(self, shape: tuple) -> None:
        want = (self.n_shards, self.n_words_local)
        if len(shape) not in (2, 3) or (shape[0], shape[-1]) != want:
            raise ValueError(
                f"pre-packed sharded semimask has shape {shape}; "
                f"this index needs [S={want[0]}, ..., W={want[1]}]")

    def shard_semimask_np(self, mask) -> np.ndarray:
        """Host-side :meth:`shard_semimask` body for bool masks:
        ``bool[..., n_total]`` -> ``uint32[S, ..., W_local]`` numpy words
        (no device transfer); the serving tier packs one row per distinct
        plan this way."""
        s, nl = self.n_shards, self.n_local
        mask = np.asarray(mask, bool)
        if mask.shape[-1] != self.n_total:
            raise ValueError(
                f"semimask covers {mask.shape[-1]} nodes but this index "
                f"has {self.n_total}")
        m = np.zeros(mask.shape[:-1] + (s * nl,), bool)
        m[..., :self.n_total] = mask
        m = np.moveaxis(m.reshape(mask.shape[:-1] + (s, nl)), -2, 0)
        return bitset.pack_np(m)

    def full_semimask(self) -> torch.Tensor:
        """Shared all-ones semimask ``[S, W_local]`` over the real
        (non-padded) rows."""
        return self.shard_semimask(np.ones(self.n_total, bool))

    def sigma(self, sel_bits: torch.Tensor):
        """Selectivity |S| / |V|: a float for a shared [S, W] mask, f32[B]
        per lane for a per-lane [S, B, W] stack."""
        tot = bitset.count_batch(sel_bits).sum(dim=0)
        if sel_bits.ndim == 3:
            return tot.to(torch.float32) / self.n_total
        return float(tot) / self.n_total

    # -- params / query prep (mirrors NavixIndex) -----------------------
    def _params(self, k, efs, heuristic, max_iters=0) -> SearchParams:
        h = (Heuristic.from_name(heuristic) if isinstance(heuristic, str)
             else Heuristic(heuristic))
        return SearchParams(k=k, efs=max(efs, k), heuristic=int(h),
                            metric=self.config.metric, max_iters=max_iters)

    def _prep_query(self, q) -> torch.Tensor:
        q = torch.as_tensor(q, dtype=torch.float32).to(self.device)
        if self.config.metric == "cos":
            q = normalize(q)
        return q.contiguous()

    # -- the per-cell programs ------------------------------------------
    def _guard(self, s: int, local_ids: torch.Tensor, d: torch.Tensor,
               alive_s: bool):
        """Shard ``s``'s local ids -> global ids with the padded-row and
        liveness guard: a padded slot's global id falls at or after
        ``n_total`` and is dropped even if a caller-built semimask (or
        ONEHOP_A, which ignores the semimask) let it into the beam."""
        gids = local_ids + s * self.n_local
        ok = (local_ids >= 0) & (gids < self.n_total) & bool(alive_s)
        return torch.where(ok, d, torch.inf), torch.where(ok, gids, -1)

    def _merged(self, shard_out, alive, width: int, with_stats: bool):
        """Guarded per-shard [B, L] outputs -> the merged SearchResult (or
        (dists, ids) without stats)."""
        out_d, out_i = merge_shard_topk(
            torch.stack([d for d, _, _ in shard_out]),
            torch.stack([g for _, g, _ in shard_out]), width)
        if not with_stats:
            return out_d, out_i
        stats = SearchStats(*(torch.stack(f) for f in
                              zip(*(st for _, _, st in shard_out))))
        return SearchResult(dists=out_d, ids=out_i,
                            stats=_masked_stats_sum(stats, alive))

    def _each_cell(self, bsz: int, fn):
        """``fn(i, s, lo, hi, dev)`` on every grid cell; per shard, the
        guarded (dists, ids, stats) of its lane blocks joined in lane
        order on the grid's first cell."""
        out = []
        for s in range(self.n_shards):
            parts = [fn(i, s, lo, hi, self._cell(i, s))
                     for i, lo, hi in self._blocks(bsz)]
            out.append((self._home([p[0] for p in parts]),
                        self._home([p[1] for p in parts]),
                        SearchStats(*(self._home(list(f)) for f in
                                      zip(*(p[2] for p in parts))))))
        return out

    def _search(self, params: SearchParams, graphs, Q: torch.Tensor,
                sel_bits: torch.Tensor, alive) -> SearchResult:
        """One-shot batched search over every shard + the global merge."""
        alive = _host_alive(alive)

        def cell(i, s, lo, hi, dev):
            # lane-local sigma against this shard's own slice of S
            # (sigma_g=None -> per-lane |S_local| / n_local)
            res = sb.search_lanes(self._cell_graph(graphs, i, s),
                                  Q[lo:hi].to(dev),
                                  self._cell_sel(sel_bits, s, lo, hi, dev),
                                  params, sigma_g=None)
            return (*self._guard(s, res.ids, res.dists, alive[s]),
                    res.stats)

        return self._merged(self._each_cell(Q.shape[0], cell), alive,
                            params.k, with_stats=True)

    def _refill(self, params: SearchParams, graphs, Q: torch.Tensor,
                sel_bits: torch.Tensor, st, udc, refill):
        refill = _host_lanes(refill)
        new_st = [list(row) for row in st]
        new_udc = [list(row) for row in udc]
        for s in range(self.n_shards):
            for i, lo, hi in self._blocks(Q.shape[0]):
                dev = self._cell(i, s)
                new_st[s][i], new_udc[s][i] = sb.refill_lanes(
                    self._cell_graph(graphs, i, s), Q[lo:hi].to(dev),
                    self._cell_sel(sel_bits, s, lo, hi, dev), st[s][i],
                    udc[s][i], refill[lo:hi], params)
        return new_st, new_udc

    def _steps(self, params: SearchParams, graphs, Q: torch.Tensor,
               sel_bits: torch.Tensor, st, n_steps: int, efs_lanes=None):
        new_st = [list(row) for row in st]
        live = []
        for i, lo, hi in self._blocks(Q.shape[0]):
            block = None
            for s in range(self.n_shards):
                dev = self._cell(i, s)
                # sigma_g=None: each shard's lanes estimate against their
                # own slice of S, exactly like the one-shot path
                new_st[s][i], lv = sb.step_lanes(
                    self._cell_graph(graphs, i, s), Q[lo:hi].to(dev),
                    self._cell_sel(sel_bits, s, lo, hi, dev), st[s][i],
                    params, n_steps, sigma_g=None,
                    efs_lanes=(None if efs_lanes is None
                               else efs_lanes[lo:hi].to(dev)))
                # a lane is live while ANY shard's beam still advances
                lv = lv.to(self.device)
                block = lv if block is None else block | lv
            live.append(block)
        return new_st, self._home(live)

    def _finalize(self, params: SearchParams, st, udc, alive,
                  with_stats: bool = True):
        alive = _host_alive(alive)

        def cell(i, s, lo, hi, dev):
            res = sb.finalize_lanes(st[s][i], udc[s][i], params)
            return (*self._guard(s, res.ids, res.dists, alive[s]),
                    res.stats)

        bsz = sum(u.shape[0] for u in udc[0])
        return self._merged(self._each_cell(bsz, cell), alive, params.efs,
                            with_stats)

    def _evict(self, st, udc, evict):
        evict = _host_lanes(evict)
        new_st = [list(row) for row in st]
        new_udc = [list(row) for row in udc]
        for s in range(self.n_shards):
            for i, lo, hi in self._blocks(evict.shape[0]):
                new_st[s][i], new_udc[s][i] = sb.evict_lanes(
                    st[s][i], udc[s][i], evict[lo:hi])
        return new_st, new_udc

    def _program(self, kind: str, params: SearchParams):
        """The memoized program of ``kind`` at ``params``."""
        key = (kind, params)
        fn = self._programs.get(key)
        if fn is None:
            if kind == "finalize_beams":
                fn = functools.partial(self._finalize, params,
                                       with_stats=False)
            else:
                fn = functools.partial(getattr(self, f"_{kind}"), params)
            self._programs[key] = fn
        return fn

    # -- resumable stepping surface (the serving tier's device side) ----
    def parked_state(self, bsz: int, params: SearchParams):
        """All-parked batch state: ``st[s][i]`` (shard s, lane block i)
        on its grid cell, and the matching ``upper_dc`` blocks."""
        blocks = self._blocks(bsz)
        st = [[sb.parked_state(self.n_local, hi - lo, params,
                               self._cell(i, s))
               for i, lo, hi in blocks] for s in range(self.n_shards)]
        udc = [[torch.zeros(hi - lo, dtype=torch.int32,
                            device=self._cell(i, s))
                for i, lo, hi in blocks] for s in range(self.n_shards)]
        return st, udc

    def refill_program(self, params: SearchParams):
        """(graphs, Q, sel_bits, st, udc, refill[B]) -> (st, udc): the
        sharded ``engine_refill``; the refill mask applies to every
        shard's copy of the lane."""
        return self._program("refill", params)

    def steps_program(self, params: SearchParams):
        """(graphs, Q, sel_bits, st, n_steps, efs_lanes=None) ->
        (st, live[B]); live is the OR over shards of each lane's
        convergence predicate, on the grid's first cell."""
        return self._program("steps", params)

    def finalize_program(self, params: SearchParams):
        """(st, udc, alive[S]) -> SearchResult with merged global ids
        ([B, efs]); dead shards contribute +inf rows to the merge."""
        return self._program("finalize", params)

    def finalize_beams_program(self, params: SearchParams):
        """(st, udc, alive[S]) -> (dists[B, efs], ids[B, efs]): the
        serving-tier finalize, bit for bit :meth:`finalize_program`'s
        merged beams without the stats reduction."""
        return self._program("finalize_beams", params)

    def evict_program(self, params: SearchParams):
        """(st, udc, evict[B]) -> (st, udc) with the flagged lanes parked
        on EVERY shard (empty converged beams, zeroed upper_dc).
        ``params`` is unused, as in the reference."""
        del params
        return self._evict

    # -- one-shot search ------------------------------------------------
    def search_many(self, Q, semimask=None, k: int = 10, efs: int = 0,
                    heuristic: str = "adaptive_local",
                    alive: Optional[np.ndarray] = None, quorum: int = 0
                    ) -> SearchResult:
        """Batched filtered search over every shard + one global merge.

        ``semimask``: ``None`` (unfiltered), ``bool[n_total]`` (shared),
        ``bool[B, n_total]`` / list of B masks (per-lane, the mixed-plan
        path), or pre-packed ``[S, W]`` / ``[S, B, W]`` words. Returns a
        :class:`SearchResult` with GLOBAL ids ([B, k]) and per-lane stats
        summed over the alive shards. Raises if fewer than ``quorum``
        shards are alive.
        """
        efs = efs or 2 * k
        params = self._params(k, efs, heuristic)
        sel = (self.full_semimask() if semimask is None
               else self.shard_semimask(semimask))
        alive = (np.ones(self.n_shards, bool) if alive is None
                 else np.asarray(alive, bool))
        if alive.shape != (self.n_shards,):
            # an index past the mask would hand some shards another
            # shard's liveness
            raise ValueError(f"alive mask has shape {alive.shape}; this "
                             f"index has {self.n_shards} shards")
        if quorum and alive.sum() < quorum:
            raise RuntimeError(
                f"quorum not met: {int(alive.sum())}/{self.n_shards} alive, "
                f"need {quorum}")
        Qp = torch.atleast_2d(self._prep_query(Q))
        if self.program_cache is not None:
            # the cache pads the lane axis to a bucket that is already
            # rounded up to a lane_shards multiple, so raw B is free here
            return self.program_cache.search_sharded(self, Qp, sel, alive,
                                                     params)
        self._check_lanes(Qp.shape[0])
        return self._program("search", params)(self.graphs, Qp, sel, alive)

    # -- compatibility wrappers -----------------------------------------
    def search_fn(self, k: int, efs: int, heuristic: str = "adaptive_local"):
        """Returns a (Q, sel_bits, alive) -> (dists, ids) function.

        Q: f32[B, d] (B divisible by the data axis); sel_bits: shared
        [S, W] or per-lane [S, B, W] words, told apart by rank; alive:
        bool[S]. Output ids are GLOBAL vector ids.
        """
        fn = self._program("search", self._params(k, efs, heuristic))

        def run(Q, sel_bits, alive):
            res = fn(self.graphs, Q, sel_bits, alive)
            return res.dists, res.ids

        return run

    def search(self, Q, semimask: np.ndarray, k: int = 100, efs: int = 0,
               heuristic: str = "adaptive_local",
               alive: Optional[np.ndarray] = None, quorum: int = 0):
        """Convenience wrapper returning ``(dists, ids)``; raises if fewer
        than ``quorum`` shards are alive."""
        res = self.search_many(Q, semimask=semimask, k=k, efs=efs,
                               heuristic=heuristic, alive=alive,
                               quorum=quorum)
        return res.dists, res.ids
