"""Multi-device SPMD over ``torch.distributed``: a data x tiles mesh of ranks.

Counterpart of ``nblic_tpu/parallel/mesh.py``.  A JAX mesh is driven by one
program that sees every device; here every rank is a process of its own
with one device, every rank calls the same function with the same
(replicated) arguments, and every rank returns the whole result, every
container or image, as the JAX functions return it to their one caller.

- ``tiles`` shards each image's tile axis.  The profile-1 encode models and
  folds each shard's tiles on the rank's device; the two tables every tile
  needs, the context-bias moments and the 12 x 256 symbol histogram, are
  ``all_reduce``'d (sum) over the data row's ``tiles`` group, then each
  shard folds its lanes (K1 on the card) and packs them as one interleave
  group.  The decode shards each image's groups, which are independent
  streams: no collective on the device (K2 on the card).
- ``data`` shards the images: pure data parallelism.  Profile 3 runs only
  this way, each rank running ``strips.encode_batch`` / ``decode_batch`` on
  its images.
- The host assembles the containers and images from ``all_gather_object``.

Rank r sits at (r // n_tiles, r % n_tiles) of the default process group,
which the caller initializes (:func:`launch` does, for ranks on one host):
NCCL where each rank has a card of its own, gloo where ranks share one or
run on the CPU.  The device is the caller's, ``cuda:<LOCAL_RANK % cards>``
by default; asking for CUDA where there is none raises (the JAX mesh's
quiet fall back to the CPU is not ported).  Bias moments are summed in
int64 (the JAX mesh sums int32 per shard: the same below 2^26 a context).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..convert import _bucket, resolve_device, tables_from_numpy
from ..models import strips, tiled
from ..ops.decode import decode_groups
from ..ops.fold import encode_fold
from ..ops.predict import model_stage1
from ..ops.rans import pad_streams
from ..utils.container import check_size

# nblic_tpu's strips.SEG_ROWS: its mesh caps a near-lossless strip at this
# height (one program a walk), so the cap changes the bytes it writes
SEG_ROWS = 128


class Mesh:
    """An ``n_data`` x ``n_tiles`` grid over the initialized default process
    group, with one ``tiles`` group a data row (every rank creates every
    row's group, in the same order).

    ``shape`` maps "data" and "tiles" to their sizes; ``data_index`` /
    ``tile_index`` are this rank's coordinates, ``device`` its device and
    ``backend`` the group's backend.
    """

    def __init__(self, n_data: int, n_tiles: int, device=None):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs torch.distributed.init_process_group first")
        world = dist.get_world_size()
        if n_data < 1 or n_tiles < 1 or n_data * n_tiles != world:
            raise ValueError(f"a {n_data} x {n_tiles} mesh needs {n_data * n_tiles} ranks, "
                             f"the process group has {world}")
        self.shape = {"data": n_data, "tiles": n_tiles}
        self.rank = dist.get_rank()
        self.data_index, self.tile_index = divmod(self.rank, n_tiles)
        self.backend = dist.get_backend()
        rows = [dist.new_group(list(range(d * n_tiles, (d + 1) * n_tiles)))
                for d in range(n_data)]
        self.tiles_group = rows[self.data_index]
        if device is None:
            cards = torch.cuda.device_count()
            local = int(os.environ.get("LOCAL_RANK", self.rank))
            device = f"cuda:{local % cards}" if cards else "cuda"
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # all_gather_object stages through the current device under NCCL
            torch.cuda.set_device(self.device)


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """1-D mesh: every rank on the ``tiles`` axis (``n_devices``, if given,
    must be the group's size)."""
    return Mesh(1, dist.get_world_size() if n_devices is None else n_devices, device)


def make_mesh2(n_data: int, n_tiles: int, device=None) -> Mesh:
    """2-D mesh: ``data`` shards images (no collective on the device),
    ``tiles`` shards each image's tile axis (all-reduced tables)."""
    return Mesh(n_data, n_tiles, device)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (gloo and NCCL both take the card's
    tensors for an all_reduce); returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _all_gather(obj) -> list:
    """Every rank's ``obj``, in rank order, on every rank."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _data_shard(items: list, mesh: Mesh) -> list:
    """This rank's share of ``items`` over ``data``, the list padded by
    repeating its last item to a multiple of the axis."""
    b_loc = -(-len(items) // mesh.shape["data"])
    d = mesh.data_index
    return [items[min(i, len(items) - 1)] for i in range(d * b_loc, (d + 1) * b_loc)]


def pad_to_multiple(tiles: torch.Tensor, n: int) -> torch.Tensor:
    """Pad the tile axis (0) to a multiple of ``n`` by repeating the last
    tile (the encoders mask the pad out)."""
    rem = -tiles.shape[0] % n
    return torch.cat([tiles, tiles[-1:].expand(rem, *tiles.shape[1:])]) if rem else tiles


def shard_tiles(tiles: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a (T, th, tw) tile batch, T a multiple of the
    ``tiles`` axis, on its device."""
    n_t = mesh.shape["tiles"]
    if tiles.shape[0] % n_t:
        raise ValueError(f"{tiles.shape[0]} tiles do not split over {n_t} shards")
    k = tiles.shape[0] // n_t
    return tiles[mesh.tile_index * k : (mesh.tile_index + 1) * k].to(mesh.device)


# ---------------------------------------------------------------------------
# profile-1 encode: tiles sharded, tables all-reduced
# ---------------------------------------------------------------------------


def _model_shard(tiles: torch.Tensor, valid, mesh: Mesh):
    """The lossless modeling pass of a shard's (B, T_loc, th, tw) tiles, the
    tables summed over the ``tiles`` group.  ``valid`` ((T_loc,) bool, or
    None for all) marks the real tiles: pad tiles add nothing to the moments
    or the histogram.  Returns y/qd (B, T_loc, th, tw) int32, bias (B, 3072)
    int32 and hist (B, 12, 256) int64, the last two the same on every shard.
    """
    x = tiles.to(torch.int32)
    return tiled._bias_fold_hist(x, *model_stage1(x), valid,
                                 lambda t: _all_reduce(t, mesh.tiles_group))


def sharded_model_lossless(tiles: torch.Tensor, mesh: Mesh):
    """The modeling pass of one image's tiles sharded over ``tiles``:
    ``tiles`` is this rank's (T_loc, th, tw) slice (:func:`shard_tiles`).
    Returns (y, qd) (T_loc, th, tw) int32 of the local tiles, and bias
    (3072,) int32 and hist (12, 256) int64 of the whole image, replicated."""
    y, qd, bias, hist = _model_shard(tiles[None], None, mesh)
    return y[0], qd[0], bias[0], hist[0]


def sharded_rans_fold(y: torch.Tensor, qd: torch.Tensor, hist_n: torch.Tensor,
                      acc: torch.Tensor):
    """The shard-local fold of the local tiles' symbols: y/qd (T_loc, th,
    tw), hist_n/acc (12, 256) normalized tables.  Returns (words, emits,
    state) as ``ops/fold.encode_fold`` (K1 on the card, the plain fold on
    the CPU), one stream a tile."""
    freq, facc = tiled._encode_tables(y[None], qd[None], hist_n[None], acc[None],
                                      g_lanes=y.shape[0])
    return encode_fold(freq, facc)


def encode_batch_mesh(imgs, mesh: Mesh, tile_h: int = 64, tile_w: int = 64) -> list[bytes]:
    """NBTC profile-1 lossless containers of same-shape images, images over
    ``data``, each image's tiles over ``tiles``: the tile axis is padded to
    a multiple of the shards, and each shard's lanes are one interleave
    group of t_total / n_tiles lanes.  Every rank returns every container;
    each is the container nblic_tpu's ``encode_batch_mesh`` writes on the
    same mesh shape.  The image count must divide ``data``."""
    if len(imgs) == 0:
        return []
    imgs = [np.ascontiguousarray(im, dtype=np.uint8) for im in imgs]
    if any(im.ndim != 2 or im.shape != imgs[0].shape for im in imgs):
        raise ValueError("encode_batch_mesh requires same-shape 2-D gray-8 images")
    h, w = imgs[0].shape
    check_size(h, w)
    n_data, n_t = mesh.shape["data"], mesh.shape["tiles"]
    if len(imgs) % n_data:
        raise ValueError("batch/tile axes must divide the mesh")
    b_loc = len(imgs) // n_data
    d, t = mesh.data_index, mesh.tile_index
    tiles = tiled.to_tiles(torch.from_numpy(np.stack(imgs[d * b_loc : (d + 1) * b_loc])),
                           tile_h, tile_w)
    t_real = tiles.shape[1]
    tiles = torch.stack([pad_to_multiple(x, n_t) for x in tiles])
    g = tiles.shape[1] // n_t  # a shard's tiles: one group
    tiles = tiles[:, t * g : (t + 1) * g].to(mesh.device)
    valid = (t * g + torch.arange(g) < t_real).to(mesh.device)
    y, qd, bias, hist = _model_shard(tiles, valid, mesh)
    totals, hist_n, payload = tiled._finish_encode_parts(y, qd, hist, g, valid)
    first = t == 0  # bias and hist_n are replicated over the row: shard 0 sends them
    parts = _all_gather((totals.cpu().numpy(), payload.cpu().numpy().astype(np.uint16),
                         bias.cpu().numpy() if first else None,
                         hist_n.cpu().numpy() if first else None))
    # rank d * n_t + t holds group t of each image of row d: reorder into
    # (image, group) and take the row's tables from its shard 0
    totals = np.stack([p[0] for p in parts]).reshape(n_data, n_t, b_loc)
    words, bias, hist_n = [], [], []
    for d in range(n_data):
        row = parts[d * n_t : (d + 1) * n_t]
        ends = [np.cumsum(p[0]) for p in row]
        for k in range(b_loc):
            words += [p[1][e[k] - p[0][k] : e[k]] for p, e in zip(row, ends)]
        bias.append(row[0][2])
        hist_n.append(row[0][3])
    return tiled._containers(1, 0, h, w, tile_h, tile_w, t_real, g,
                             totals.transpose(0, 2, 1).reshape(len(imgs), n_t),
                             np.concatenate(bias), np.concatenate(hist_n),
                             np.concatenate(words))


# ---------------------------------------------------------------------------
# profile-1/2 decode: groups sharded, no collective on the device
# ---------------------------------------------------------------------------


def decode_batch_mesh(streams: list[bytes], mesh: Mesh) -> list[np.ndarray]:
    """Decode same-geometry NBTC profile-1/2 containers (any ``near``):
    images over ``data`` (the batch padded by repeating the last), each
    image's groups over ``tiles`` (padded with groups of no live lane).
    Each rank runs the group decode (K2 on the card) on its rows of groups;
    every rank returns every image, as ``tiled.decode_batch`` decodes it."""
    if len(streams) == 0:
        return []
    parsed = [tiled._Parsed(s) for s in streams]

    def geometry(p):
        hd = p.hdr
        return (hd.height, hd.width, hd.tile_h, hd.tile_w, hd.near, hd.profile,
                p.group_size, len(p.counts))

    if any(geometry(p) != geometry(parsed[0]) for p in parsed):
        raise ValueError("decode_batch_mesh requires same-geometry streams")
    h0 = parsed[0].hdr
    n_t = mesh.shape["tiles"]
    g, n_groups = parsed[0].group_size, len(parsed[0].counts)
    g_loc = -(-n_groups // n_t)
    t = mesh.tile_index
    mine = _data_shard(parsed, mesh)
    b_loc = len(mine)
    wmax = _bucket(max(max(int(p.counts.max()) for p in parsed), 2 * g))

    def rows(a):  # this shard's groups of one image, pad groups zero
        a = np.concatenate([a, np.zeros((g_loc * n_t - len(a),) + a.shape[1:], a.dtype)])
        return a[t * g_loc : (t + 1) * g_loc]

    dev = mesh.device
    words = torch.from_numpy(np.concatenate(
        [rows(pad_streams(p.payload, p.counts, wmax)) for p in mine])).to(dev)
    n_active = torch.from_numpy(np.concatenate([rows(p.n_active()) for p in mine])).to(dev)
    wcols = None
    if h0.profile == 2:
        wcols = torch.from_numpy(np.concatenate([rows(p.weight_cols()) for p in mine])).to(dev)
    tables = tables_from_numpy(np.stack([p.bias for p in mine]),
                               np.stack([p.hist_n for p in mine]),
                               np.stack([p.acc for p in mine]), dev)
    lanes = decode_groups(words, n_active, *tables, wcols, h0.tile_h, h0.tile_w, h0.near,
                          g, h0.profile)
    parts = _all_gather(lanes.cpu().numpy().reshape(b_loc, g_loc * g, h0.tile_h, h0.tile_w))
    out = []
    for i, p in enumerate(parsed):
        d, k = divmod(i, b_loc)
        img_lanes = np.concatenate([parts[d * n_t + s][k] for s in range(n_t)])
        img = tiled.from_tiles(torch.from_numpy(img_lanes[: h0.n_tiles]), h0.height, h0.width,
                               h0.tile_h, h0.tile_w).numpy()
        out.append(np.ascontiguousarray(img.T if p.hdr.transposed else img))
    return out


# ---------------------------------------------------------------------------
# profile 3 (the strip engine): pure data parallelism over ``data``
# ---------------------------------------------------------------------------


def _gather_rows(local: list, mesh: Mesh, n: int) -> list:
    """The first ``n`` items of every data row's ``local`` (those of each
    row's shard 0; the row's other shards computed the same), in order."""
    parts = _all_gather(local if mesh.tile_index == 0 else None)
    return [x for part in parts if part is not None for x in part][:n]


def p3_encode_batch_mesh(imgs, mesh: Mesh, th: int | None = None,
                         near: int = 0) -> list[bytes]:
    """Profile-3 containers of images whose shapes agree after portrait
    normalization, images over ``data``: each rank runs
    ``strips.encode_batch`` on its own images.  Containers equal the
    single-process engine's at the strip height used: ``th`` (default
    ``strips.TH_DEFAULT``) capped at :data:`SEG_ROWS` when ``near`` > 0,
    as nblic_tpu's mesh caps it, and at the portrait height."""
    if len(imgs) == 0:
        return []
    imgs = [np.ascontiguousarray(im, dtype=np.uint8) for im in imgs]
    if any(im.ndim != 2 for im in imgs) or len(
            {tuple(sorted(im.shape, reverse=True)) for im in imgs}) > 1:
        raise ValueError("mesh encode requires same-shape images")
    th = strips.TH_DEFAULT if th is None else th
    if near:
        th = min(th, SEG_ROWS)
    conts = strips.encode_batch(_data_shard(imgs, mesh), th=th, near=near, device=mesh.device)
    return _gather_rows(conts, mesh, len(imgs))


def p3_decode_batch_mesh(streams: list[bytes], mesh: Mesh) -> list[np.ndarray]:
    """Decode profile-3 containers of one plane geometry and model, images
    over ``data``: each rank runs ``strips.decode_batch`` on its own.
    Static-bias (legacy) and mixed-geometry batches are refused, as
    nblic_tpu's mesh refuses them."""
    if len(streams) == 0:
        return []
    parsed = [strips._parse(s) for s in streams]
    geom = strips._plane_geom(parsed[0][0])
    if any(strips._plane_geom(p[0]) != geom or p[1] is not None for p in parsed):
        raise ValueError("p3 mesh decode requires same-geometry adaptive containers")
    imgs = strips.decode_batch(_data_shard(list(streams), mesh), device=mesh.device)
    return _gather_rows(imgs, mesh, len(streams))


# ---------------------------------------------------------------------------
# ranks on one host
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, backend, timeout, fn, args, results) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, send its result
    (or its traceback, which reaches the parent before the exit code)."""
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    # NCCL binds a rank to its card at once (a card a rank: the Mesh's default)
    bind = ({"device_id": torch.device("cuda", rank % torch.cuda.device_count())}
            if backend == "nccl" else {})
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout), **bind)
    try:
        results.put((rank, True, fn(*args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def launch(world_size: int, fn, *args, backend: str = "gloo",
           timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks, each a spawned process of
    this host (``LOCAL_RANK`` its rank, torch on one intra-op thread) with
    the default process group initialized: ``backend``, tcp://localhost at a
    free port, ``timeout`` seconds for every collective.  ``fn`` is pickled
    by reference.  Returns each rank's result, in rank order.  Raises
    RuntimeError, with the first failing rank's traceback, when a rank fails
    or the group is not done within ``timeout``; every process it started
    has ended when it returns."""
    results = multiprocessing.get_context("spawn").Queue()
    ranks = torch.multiprocessing.start_processes(
        _rank_main, (world_size, _free_port(), backend, timeout, fn, args, results),
        nprocs=world_size, join=False, start_method="spawn")
    done = {}
    deadline = time.monotonic() + timeout
    try:
        # a rank exits only once its result has left for this process, so
        # take results while waiting for the ranks to end
        while not ranks.join(timeout=0):
            if time.monotonic() > deadline:
                raise RuntimeError(f"the group of {world_size} ranks outlasted {timeout} s")
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            done[rank] = value
        while len(done) < world_size:
            rank, _, done[rank] = results.get(timeout=timeout)
    except (torch.multiprocessing.ProcessRaisedException,
            torch.multiprocessing.ProcessExitedException, RuntimeError) as exc:
        raise RuntimeError(f"launch({world_size}, {getattr(fn, '__name__', fn)}): {exc}") from None
    finally:
        for p, error_file in zip(ranks.processes, ranks.error_files):
            if p.is_alive():
                p.kill()
            p.join()
            if os.path.exists(error_file):
                os.unlink(error_file)
    return [done[r] for r in range(world_size)]
