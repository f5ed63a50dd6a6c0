"""Multi-device mapping: data-parallel reads x key-range-sharded index.

Port of ``gdiet_tpu/parallel/dist.py``. The reference's only multi-shard
construct is the multi-part index whose per-part hits are merged on disk
(GDiet-ShortReads/splitidx.c, map.c:1094-1163); ``gdiet_tpu`` replaces it
with a 2-D device mesh, and so does the port:

  data axis: a batch of reads is split into ``n_data`` equal rows of reads;
  ref axis:  the sorted minimizer index is split into ``n_ref`` contiguous
             key ranges, one shard per ref device (``ShardedIndex``). A seed
             probe runs against every shard; the global occurrence counts
             are the shards' sum (``psum_ref``), each shard expands its own
             hits, and the shards' strand streams are concatenated in ref
             order (``all_gather_ref``) and sorted by key before the vote.

One process drives the whole grid of ``torch.device``s, as one controller
drives ``shard_map``: everything after the merge runs once per data row on
its lead device (ref index 0), where ``shard_map`` runs it on every ref
device of the row with the same result. Copies between devices are
``.to(device)``. An explicit device list gives a virtual mesh (every cell
on ``"cpu"``, or on ``"cuda:0"``), which runs the same sharded path on one
device.

``init_distributed`` is the ``GDIET_COORDINATOR`` join: a gloo process
group whose processes each map their own reads (it carries no mapping
data, as in ``gdiet_tpu``).

The two collectives live in ``pipeline/device_step.py``, which the
sharded steps call; this module re-exports them.
"""

from __future__ import annotations

import datetime
from dataclasses import replace

import numpy as np
import torch

from gdiet_tpu_torch import u64
from gdiet_tpu_torch.index.build import bucket_table, lookup_vals
from gdiet_tpu_torch.pipeline.device_step import (_pattern_tables, all_gather_ref, at_width,
                                                  dp_rows, fused_map_step, psum_ref,
                                                  ref_tables, staged_times, step_config)
from gdiet_tpu_torch.pipeline.lr_step import lr_front

__all__ = ["Mesh", "ShardedFused", "ShardedIndex", "all_gather_ref", "build_sharded_mapper",
           "device_mesh", "init_distributed", "make_mesh", "psum_ref", "sharded_lr_front",
           "sharded_step", "shutdown_distributed"]

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
JOIN_TIMEOUT = datetime.timedelta(seconds=300)


# ---------------------------------------------------------------------------
# the mesh and the process group
# ---------------------------------------------------------------------------
class Mesh:
    """A (data, ref) grid of devices: ``devices[d][r]``; row d's lead
    device is ``devices[d][0]``."""

    def __init__(self, devices: list):
        self.devices = devices
        self.shape = {"data": len(devices), "ref": len(devices[0])}

    def lead(self, d: int) -> torch.device:
        return self.devices[d][0]

    def distinct(self) -> list:
        """The mesh's distinct devices, in grid order."""
        return list(dict.fromkeys(dev for row in self.devices for dev in row))


def make_mesh(n_data: int, n_ref: int, devices=None) -> Mesh:
    """An ``n_data`` x ``n_ref`` mesh over ``devices`` (row-major), or over
    ``cuda:0 .. cuda:n-1`` when None, which needs that many visible cards.
    A list that repeats a device gives a virtual mesh."""
    n = n_data * n_ref
    if n_data < 1 or n_ref < 1:
        raise ValueError(f"mesh {n_data}x{n_ref}: both sizes must be >= 1")
    if devices is None:
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"mesh {n_data}x{n_ref} needs {n} CUDA devices, "
                             f"{have} visible")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if len(devs) < n:
        raise ValueError(f"mesh {n_data}x{n_ref} needs {n} devices, {len(devs)} given")
    return Mesh([devs[d * n_ref:(d + 1) * n_ref] for d in range(n_data)])


def device_mesh(shape: tuple, device) -> Mesh:
    """The ``--mesh DATAxREF`` mesh of the CLI: a virtual mesh of the CPU
    with ``--device cpu``, one card per cell with a CUDA device."""
    n_data, n_ref = shape
    if torch.device(device).type == "cpu":
        return make_mesh(n_data, n_ref, ["cpu"] * (n_data * n_ref))
    return make_mesh(n_data, n_ref)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Join the process group at ``coordinator`` (host:port) as rank
    ``process_id`` of ``num_processes`` (gloo, ``JOIN_TIMEOUT``); returns
    the group's world size. A no-op returning 1 without a coordinator."""
    if coordinator is None:
        return 1
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes or 1, rank=process_id or 0,
                            timeout=JOIN_TIMEOUT)
    return dist.get_world_size()


def shutdown_distributed(wait: bool = True) -> None:
    """Leave the process group: after every process reached here when
    ``wait`` (a barrier), at once otherwise."""
    import torch.distributed as dist

    if dist.is_initialized():
        if wait:
            dist.barrier()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the sharded index
# ---------------------------------------------------------------------------
class ShardedIndex:
    """Key-range split of an index's sorted keys into ``n_ref`` padded
    shards (dist.py:59-116).

    Every occurrence list stays whole on its owning shard, so a shard's
    local counts are exact (0 on the others) and their sum is the global
    occurrence count. ``keys`` [n_ref, kpad] (U64_MAX padding), ``starts``
    [n_ref, kpad+1] (padded keys count 0), ``positions`` [n_ref, ppad],
    ``buckets`` [n_ref, 2^b+1] on the whole index's common
    ``bucket_shift``, ``bucket_iters`` the deepest shard's search depth;
    the arrays equal ``gdiet_tpu``'s bit for bit."""

    def __init__(self, index, n_ref: int):
        K = len(index.keys)
        bounds = [K * i // n_ref for i in range(n_ref + 1)]
        kpad = max(bounds[i + 1] - bounds[i] for i in range(n_ref))
        ppad = 1
        shards = []
        for i in range(n_ref):
            lo, hi = bounds[i], bounds[i + 1]
            pos_lo, pos_hi = int(index.starts[lo]), int(index.starts[hi])
            shards.append((index.keys[lo:hi],
                           (index.starts[lo:hi + 1] - pos_lo).astype(np.int64),
                           index.positions[pos_lo:pos_hi]))
            ppad = max(ppad, pos_hi - pos_lo)
        keys = np.full((n_ref, max(kpad, 1)), U64_MAX, np.uint64)
        starts = np.zeros((n_ref, max(kpad, 1) + 1), np.int64)
        positions = np.zeros((n_ref, ppad), np.uint64)
        for i, (k, s, p) in enumerate(shards):
            keys[i, :len(k)] = k
            starts[i, :len(s)] = s
            starts[i, len(s):] = len(p)  # padded keys get zero counts
            positions[i, :len(p)] = p
        # per-shard bucket tables on the whole index's geometry, so that
        # every shard buckets a key alike
        _, self.bucket_shift, _ = bucket_table(index.keys, index.k)
        b = 2 * index.k - self.bucket_shift
        bnds = np.arange((1 << b) + 1, dtype=np.uint64) << np.uint64(self.bucket_shift)
        buckets, iters = [], 1
        for k_, _, _ in shards:
            buckets.append(np.searchsorted(k_, bnds).astype(np.int64))
            if len(k_):
                iters = max(iters, int(np.ceil(np.log2(np.max(np.diff(buckets[-1])) + 1))) + 1)
        self.buckets = np.stack(buckets)
        self.bucket_iters = iters
        self.n_ref = n_ref
        self.keys = keys
        self.starts = starts
        self.positions = positions
        self._dev: dict = {}

    def shard(self, r: int, device) -> dict:
        """Shard ``r``'s probe tables on ``device`` (made once per device):
        keys and packed values (int64 bit patterns), bucket table,
        positions."""
        device = torch.device(device)
        key = (r, device)
        if key not in self._dev:
            self._dev[key] = {
                "keys": u64.from_numpy(self.keys[r], device),
                "vals": u64.from_numpy(lookup_vals(self.starts[r]), device),
                "buckets": torch.from_numpy(self.buckets[r]).to(device),
                "positions": u64.from_numpy(self.positions[r], device),
            }
        return self._dev[key]


def _row_tables(mesh: Mesh, sh: ShardedIndex, shared) -> list:
    """Per data row: the ``shared`` tables on its lead device (made once
    per distinct lead) and its ref devices' shards."""
    by_lead: dict = {}
    rows = []
    for d in range(mesh.shape["data"]):
        lead = mesh.lead(d)
        if lead not in by_lead:
            by_lead[lead] = shared(lead)
        rows.append({**by_lead[lead],
                     "shards": [sh.shard(r, dev) for r, dev in enumerate(mesh.devices[d])]})
    return rows


def _rows(mesh: Mesh, *tensors) -> list:
    """Each data row's slices of the [B, ...] ``tensors`` on its lead
    device; B must be a multiple of the data-axis size."""
    n_data = mesh.shape["data"]
    B = tensors[0].shape[0]
    if B % n_data:
        raise ValueError(f"batch of {B} rows on a mesh of {n_data} data rows")
    bl = B // n_data
    return [[t[d * bl:(d + 1) * bl].to(mesh.lead(d)) for t in tensors]
            for d in range(n_data)]


# ---------------------------------------------------------------------------
# the sharded steps
# ---------------------------------------------------------------------------
def _sharded(mesh: Mesh, index, cfg):
    """The index split over ``mesh``'s ref axis, and ``cfg`` with the
    bisect probe on its geometry (dist.py:138-141, :216)."""
    sh = ShardedIndex(index, mesh.shape["ref"])
    return sh, replace(cfg, probe="bisect", bucket_shift=sh.bucket_shift,
                       bucket_iters=sh.bucket_iters)


def sharded_step(mesh: Mesh, index, cfg):
    """The multi-device short-read step over ``mesh`` (dist.py:119-191).

    Returns (cfg as the step runs it, fn(codes [B, Lmax] u8, lens [B] i64,
    upto=None) -> {"meta": [B, 3+12K] i32, "ops": [n_data * N2, OB] u8})
    on the first row's lead device: each data row's meta and compacted op
    rows concatenated in row order (each row's ``opsrow`` indexes its own
    op rows, as ``shard_map``'s data-sharded outputs do), B a multiple of
    the data-axis size. ``upto`` cuts each row's step as ``fused_map_step``
    does and returns the list of per-row results."""
    sh, cfg = _sharded(mesh, index, cfg)
    rows = _row_tables(mesh, sh, lambda dev: ref_tables(index, cfg, dev))
    out_dev = mesh.lead(0)

    def step(codes, lens, upto: str | None = None, mark=None):
        outs = [fused_map_step(c, ln, tables, cfg, upto=upto, mark=mark)
                for (c, ln), tables in zip(_rows(mesh, codes, lens), rows)]
        if upto is not None:
            return outs
        return {name: torch.cat([o[name].to(out_dev) for o in outs])
                for name in ("meta", "ops")}

    return cfg, step


def sharded_lr_front(mesh: Mesh, index, cfg, k: int, vt_df1: float, vt_f: float,
                     bw: int):
    """The long-read analog of ``sharded_step`` (dist.py:194-259): the LR
    device front (``lr_step.lr_front``) per data row over the sharded
    index. Returns fn(codes, lens, cov_thr, vt_dis) -> the packed meta [B,
    4 + 8K + 4 + 16] i32 on the first row's lead device, B a multiple of
    the data-axis size; the host finish reads it unchanged. ``codes`` may
    be narrower than ``cfg.Lmax``: each width runs at ``at_width(cfg,
    width)``, its pattern tables made once."""
    sh, cfg = _sharded(mesh, index, cfg)
    out_dev = mesh.lead(0)
    by_width: dict = {}

    def front(codes, lens, cov_thr, vt_dis):
        width = codes.shape[1]
        if width not in by_width:
            cw = at_width(cfg, width)
            maps, pref, _ = _pattern_tables(cw)
            by_width[width] = cw, _row_tables(
                mesh, sh, lambda dev: {"maps": torch.from_numpy(maps).to(dev),
                                       "pref": torch.from_numpy(pref).to(dev)})
        cw, rows = by_width[width]
        return torch.cat([
            lr_front(c, ln, tables, cov, dis, cfg=cw, k=k, vt_df1=vt_df1, vt_f=vt_f,
                     bw=bw).to(out_dev)
            for (c, ln, cov, dis), tables in zip(_rows(mesh, codes, lens, cov_thr, vt_dis),
                                                 rows)])

    return front


def build_sharded_mapper(index, mo, mesh: Mesh, Lmax: int = 256, S: int = 160,
                         S2: int = 64, A: int = 1024, dp_frac: float = 1.0):
    """StepConfig + sharded step for (index, mo) (dist.py:262-280).
    Returns ``sharded_step``'s (cfg, step)."""
    return sharded_step(mesh, index, replace(step_config(index, mo, Lmax, S, S2, A),
                                             dp_frac=dp_frac))


class ShardedFused:
    """Drop-in replacement for ``TorchFusedMapper`` running the sharded step
    on a (data, ref) mesh (dist.py:283-310): the same ``inputs``,
    ``step``, ``__call__``, ``fetch``, ``sync`` and ``staged_times``.

    ``inputs`` pads the batch to a multiple of the data-axis size (codes
    255, length 0); ``fetch`` globalizes each data row's local ``opsrow``
    by ``d * n2_local(B)``, the row's first op row in the concatenated ops,
    and drops the padding rows. The sharded step never folds the DP
    (dist.py:262-280)."""

    def __init__(self, index, mo, mesh: Mesh, Lmax: int = 256, S: int = 160,
                 S2: int = 64, A: int = 1024, dp_frac: float = 1.0):
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.device = mesh.lead(0)
        self.cfg, self.step = build_sharded_mapper(
            index, mo, mesh, Lmax=Lmax, S=S, S2=S2, A=A, dp_frac=dp_frac)

    def n2_local(self, B: int) -> int:
        """Compacted op rows of one data row of a (padded) batch of B."""
        return dp_rows((B // self.n_data) * self.cfg.K, self.cfg.dp_frac)

    def inputs(self, codes: np.ndarray, lens: np.ndarray):
        pad = (-len(lens)) % self.n_data
        if pad:
            codes = np.concatenate([codes, np.full((pad, codes.shape[1]), 255, np.uint8)])
            lens = np.concatenate([lens, np.zeros(pad, np.int64)])
        c = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(self.device)
        ln = torch.from_numpy(np.ascontiguousarray(lens, np.int64)).to(self.device)
        return c, ln

    def __call__(self, codes: np.ndarray, lens: np.ndarray, mark=None) -> dict:
        return self.step(*self.inputs(codes, lens), mark=mark)

    def fetch(self, dev: dict, B: int):
        """(meta [B, 3+12K] i32 with global ``opsrow``, ops u8) numpy."""
        meta = dev["meta"].cpu().numpy().copy()  # a CPU tensor's numpy() is a view
        K = self.cfg.K
        bl = meta.shape[0] // self.n_data
        n2 = self.n2_local(meta.shape[0])
        rows = meta[:, 3 + 11 * K:3 + 12 * K]  # opsrow (device_step.PACK_BK)
        for d in range(1, self.n_data):
            blk = rows[d * bl:(d + 1) * bl]
            blk[blk >= 0] += d * n2
        return meta[:B], dev["ops"].cpu().numpy()

    def sync(self) -> None:
        for dev in self.mesh.distinct():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def staged_times(self, codes: np.ndarray, lens: np.ndarray) -> dict:
        return staged_times(self, codes, lens)
