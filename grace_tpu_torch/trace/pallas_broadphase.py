"""Dense segment culling broadphase (PyTorch counterpart of
``grace_tpu.trace.pallas_broadphase``).

Every ray tile's AABB is tested against every ``block``-primitive segment
of the Morton-sorted particle array, and the overlaps are packed into i32
bitmask words (bit s of word w = segment w*32+s). ``compact_mask_words``
turns words into per-tile ascending id lists (``quarter_lists``,
``dense_tile_segments``). Words, summaries and lists are bit-exact with
``grace_tpu``.

On CUDA tensors each step is a kernel of ``csrc/broadphase.cu``: both
box sets in one launch (``broadphase_boxes_cuda``, ``grace_broadphase_boxes``;
``segment_aabbs`` and ``tile_aabbs`` launch it with the other part empty),
the overlap words with their summary (``grace_overlap_words``: a block a
strip of 32 words, each row tested against the words' hulls first and a
ballot a candidate word, no dense intermediate) and the compaction
(``grace_compact_words``: a warp a row, 128 words a group from 16-byte
loads, consecutive slots from consecutive lanes, the padding as streaming
16-byte stores). CPU tensors take the plain
versions, ``_<name>_plain``: the dense bool matrix, ``seg_block`` segments
at a time, packed to words, and a compaction that ranks every bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from grace_tpu_torch import _kernels
from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.ops.primitives import sphere_aabb
from grace_tpu_torch.trace.broadphase import _check_tile, _on_cpu, _tile_aabbs_plain, tile_aabbs

SEG = 128
_F32_MAX = torch.finfo(torch.float32).max


def _segment_aabbs_plain(spheres: torch.Tensor, block: int = SEG
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``segment_aabbs``."""
    n = spheres.shape[0]
    n_pad = ((n + SEG - 1) // SEG) * SEG
    mins, maxs = sphere_aabb(spheres)
    pad = lambda a, v: torch.cat([a, a.new_full((n_pad - n, 3), v)])
    seg_min = pad(mins, _F32_MAX).reshape(-1, block, 3).amin(dim=1)
    seg_max = pad(maxs, -_F32_MAX).reshape(-1, block, 3).amax(dim=1)
    return seg_min, seg_max


def segment_aabbs(spheres: torch.Tensor, block: int = SEG
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABBs of each ``block``-primitive segment of the sorted particle
    array, padded to a SEG multiple with empty boxes. ``block`` divides SEG
    (32 or 128 on CUDA tensors)."""
    if _on_cpu(spheres):
        return _segment_aabbs_plain(spheres, block)
    return broadphase_boxes_cuda(None, 1, spheres, block)[1]


def broadphase_boxes_cuda(rays: Rays | None, tile: int, spheres: torch.Tensor | None,
                          block: int = SEG):
    """``csrc/broadphase.cu``'s ``grace_broadphase_boxes``: ``tile_aabbs(rays,
    tile)`` and ``segment_aabbs(spheres, block)`` in one launch, as
    ``((tmin, tmax), (seg_min, seg_max))``, the four views of one allocation
    (each 16-byte aligned: the overlap words stage their column boxes so).
    ``rays`` or ``spheres`` None leaves that part empty."""
    parts = ([] if spheres is None else [spheres]) + (
        [] if rays is None else [rays.origins, rays.directions, rays.lengths])
    device = _kernels.check_tensors("broadphase_boxes", [], parts)
    if block not in (32, SEG):
        raise ValueError(f"segment_aabbs: block {block}, the kernel takes 32 or {SEG}")
    n = n_tiles = 0
    inputs = [None] * 4   # spheres, origins, directions, lengths
    if spheres is not None:
        if spheres.dim() != 2 or spheres.shape[1] != 4:
            raise ValueError(f"segment_aabbs: spheres {tuple(spheres.shape)}, expected [n, 4]")
        inputs[0] = _kernels.aligned(spheres)
        n = spheres.shape[0]
    if rays is not None:
        _check_tile(rays, tile)
        n_tiles = rays.n_rays // tile
        inputs[1:] = [t.contiguous() for t in parts[-3:]]
    n_boxes = (n + SEG - 1) // SEG * (SEG // block)
    # each set in whole float4s (rows padded to a multiple of 4), the rows
    # past a set's own cut off only where there are any
    rows = (-(-n_boxes // 4) * 4, -(-n_tiles // 4) * 4)
    buf = torch.empty((2 * (rows[0] + rows[1]), 3), dtype=torch.float32, device=device)
    seg_min, seg_max, tmin, tmax = buf.split_with_sizes([rows[0], rows[0], rows[1], rows[1]])
    if rows[0] != n_boxes:
        seg_min, seg_max = seg_min[:n_boxes], seg_max[:n_boxes]
    if rows[1] != n_tiles:
        tmin, tmax = tmin[:n_tiles], tmax[:n_tiles]
    if n_boxes or n_tiles:
        _kernels.launch("broadphase", "grace_broadphase_boxes", device,
                        *(None if t is None else t.data_ptr() for t in inputs),
                        *(t.data_ptr() for t in (seg_min, seg_max, tmin, tmax)), n, block,
                        n_tiles, tile)
        broadphase_boxes_cuda.launches += 1
    return (tmin, tmax), (seg_min, seg_max)


broadphase_boxes_cuda.launches = 0


def broadphase_boxes_resources(device, vec: bool = True) -> dict:
    """What one launch of ``grace_broadphase_boxes``' kernel holds on
    ``device`` (its 16-byte ray route, or with ``vec`` False the 4-byte
    one): ``_kernels.RESOURCE_FIELDS`` and ``local_bytes`` a thread."""
    fields = _kernels.RESOURCE_FIELDS + ("local_bytes",)
    out = (ctypes.c_int * len(fields))()
    _kernels.launch("broadphase", "grace_broadphase_boxes_resources", torch.device(device),
                    ctypes.addressof(out), int(vec))
    return dict(zip(fields, out))


def overlap_words_cuda(row_min, row_max, col_min, col_max, summary: bool = False):
    """``csrc/broadphase.cu``'s ``grace_overlap_words``: the i32 overlap
    words [rows, ceil(cols / 32)] of row boxes against column boxes (bit s
    of word w: column w*32+s), and with ``summary`` their summary words
    [rows, ceil(words / 32)] (bit w of word s: word s*32+w is nonzero).
    The test is symmetric, so rows and columns may be tiles or segments."""
    device = _kernels.check_tensors("overlap_words", [], [row_min, row_max, col_min, col_max])
    n_rows, n_cols = row_min.shape[0], col_min.shape[0]
    if (row_max.shape != (n_rows, 3) or row_min.shape != (n_rows, 3)
            or col_min.shape != (n_cols, 3) or col_max.shape != (n_cols, 3)):
        raise ValueError("overlap_words: boxes must be [n, 3] (min, max) pairs, got "
                         f"{[tuple(t.shape) for t in (row_min, row_max, col_min, col_max)]}")
    n_words = (n_cols + 31) // 32
    boxes = [t.contiguous() for t in (row_min, row_max)] + [
        _kernels.aligned(t) for t in (col_min, col_max)]
    words = torch.empty((n_rows, n_words), dtype=torch.int32, device=device)
    summ = (torch.empty((n_rows, (n_words + 31) // 32), dtype=torch.int32, device=device)
            if summary else None)
    _kernels.launch("broadphase", "grace_overlap_words", device,
                    *[t.data_ptr() for t in boxes], words.data_ptr(),
                    None if summ is None else summ.data_ptr(), n_rows, n_cols)
    overlap_words_cuda.launches += 1
    return (words, summ) if summary else words


overlap_words_cuda.launches = 0


def overlap_words_resources(device) -> dict:
    """What one launch of ``grace_overlap_words``' kernel holds on
    ``device``: ``_kernels.RESOURCE_FIELDS`` and ``local_bytes`` a thread."""
    fields = _kernels.RESOURCE_FIELDS + ("local_bytes",)
    out = (ctypes.c_int * len(fields))()
    _kernels.launch("broadphase", "grace_overlap_words_resources", torch.device(device),
                    ctypes.addressof(out))
    return dict(zip(fields, out))


def pack_overlap_bits(overlap: torch.Tensor) -> torch.Tensor:
    """Pack a bool [n_tiles, n_segs] matrix into i32 words
    [n_tiles, ceil(n_segs/32)] (bit s of word w = segment w*32+s)."""
    n_tiles, n_segs = overlap.shape
    pad = (-n_segs) % 32
    if pad:
        overlap = torch.cat([overlap, overlap.new_zeros((n_tiles, pad))], dim=1)
    b = overlap.reshape(n_tiles, -1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=overlap.device)
    words = (b << shifts).sum(dim=2)
    # reinterpret the uint32 word as int32
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


def _masks_for_tile_aabbs_plain(tmin, tmax, spheres, seg_block: int = 8192,
                                block: int = SEG) -> torch.Tensor:
    """Plain PyTorch version of ``masks_for_tile_aabbs``: the dense bool
    matrix ``seg_block`` segments at a time, packed to words."""
    seg_min, seg_max = _segment_aabbs_plain(spheres, block=block)

    def block_words(s_min, s_max):
        overlap = (
            (tmin[:, 0:1] <= s_max[:, 0]) & (s_min[:, 0] <= tmax[:, 0:1])
            & (tmin[:, 1:2] <= s_max[:, 1]) & (s_min[:, 1] <= tmax[:, 1:2])
            & (tmin[:, 2:3] <= s_max[:, 2]) & (s_min[:, 2] <= tmax[:, 2:3])
        )
        return pack_overlap_bits(overlap)

    n_segs = seg_min.shape[0]
    if n_segs <= seg_block:
        return block_words(seg_min, seg_max)
    if seg_block % 32:
        raise ValueError("seg_block must be a multiple of 32")
    # Each block's words are whole words: blocks start on 32-segment
    # boundaries, and the last block's padding bits are zero.
    words = [block_words(seg_min[s:s + seg_block], seg_max[s:s + seg_block])
             for s in range(0, n_segs, seg_block)]
    return torch.cat(words, dim=1)[:, : (n_segs + 31) // 32]


def masks_for_tile_aabbs(tmin, tmax, spheres, seg_block: int = 8192,
                         block: int = SEG) -> torch.Tensor:
    """Overlap words of precomputed ray-tile AABBs against ``block``-
    primitive segments: i32[n_tiles, ceil(n_segs/32)]. On CUDA tensors
    ``segment_aabbs`` and one overlap-words launch (``seg_block``, the
    plain version's working set, is not used)."""
    if _on_cpu(spheres):
        return _masks_for_tile_aabbs_plain(tmin, tmax, spheres, seg_block, block)
    return overlap_words_cuda(tmin, tmax, *segment_aabbs(spheres, block))


def _dense_tile_masks_plain(rays: Rays, spheres, tile: int, seg_block: int = 8192):
    tmin, tmax = _tile_aabbs_plain(rays, tile)
    return _masks_for_tile_aabbs_plain(tmin, tmax, spheres, seg_block)


def dense_tile_masks(rays: Rays, spheres, tile: int, seg_block: int = 8192):
    """Seg-128 bitmask broadphase: i32[n_tiles, ceil(n_segs/32)] words. On
    CUDA tensors both box sets in one launch, then one overlap-words
    launch."""
    if _on_cpu(spheres):
        return _dense_tile_masks_plain(rays, spheres, tile, seg_block)
    tiles, segs = broadphase_boxes_cuda(rays, tile, spheres, SEG)
    return overlap_words_cuda(*tiles, *segs)


def _dense_tile_masks_quarter_plain(rays: Rays, spheres, tile: int, seg_block: int = 8192):
    tmin, tmax = _tile_aabbs_plain(rays, tile)
    words = _masks_for_tile_aabbs_plain(tmin, tmax, spheres, seg_block, block=32)
    return words, pack_overlap_bits(words != 0)


def dense_tile_masks_quarter(rays: Rays, spheres, tile: int, seg_block: int = 8192):
    """Quarter-granularity (32-primitive) bitmask broadphase. Returns

      words   i32[n_tiles, ceil(n_q / 32)]     bit q of word w = quarter
                                               w*32+q overlaps the tile box
      summary i32[n_tiles, ceil(words / 32)]   bit w of summary word s =
                                               word s*32+w is nonzero

    On CUDA tensors both box sets come from one launch, the words and the
    summary from one overlap-words launch.
    """
    if _on_cpu(spheres):
        return _dense_tile_masks_quarter_plain(rays, spheres, tile, seg_block)
    tiles, quarters = broadphase_boxes_cuda(rays, tile, spheres, 32)
    return overlap_words_cuda(*tiles, *quarters, summary=True)


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of i32 words (SWAR, on the unsigned value)."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _compact_mask_words_plain(words: torch.Tensor, max_q: int, rows: int = 1024):
    """Plain PyTorch version of ``compact_mask_words``: the bits are
    unpacked and each set bit is scattered to its rank (a running count
    along the row), ``rows`` tiles at a time to bound the [rows, n_words *
    32] intermediates."""
    n_tiles, n_words = words.shape
    dev = words.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    ids = torch.zeros((n_tiles, max_q + 1), dtype=torch.int32, device=dev)
    counts = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    bit_ids = torch.arange(n_words * 32, dtype=torch.int32, device=dev)
    for r0 in range(0, n_tiles, rows):
        w = words[r0:r0 + rows]
        bits = ((w[:, :, None] >> shifts) & 1).reshape(w.shape[0], -1)
        rank = torch.cumsum(bits, dim=1, dtype=torch.int32) - 1
        slot = torch.where((bits == 1) & (rank < max_q), rank, max_q).long()
        ids[r0:r0 + rows].scatter_(1, slot, bit_ids.expand_as(slot))
        counts[r0:r0 + rows] = bits.sum(dim=1, dtype=torch.int32)
    # the spare column took the unset bits and the ranks past max_q
    return ids[:, :max_q].contiguous(), torch.clamp(counts, max=max_q), counts > max_q


def compact_mask_words(words: torch.Tensor, max_q: int, rows: int = 1024):
    """Set-bit compaction of bitmask words into per-tile id lists.

    ``grace_tpu``'s form is gather-free one-hot matmuls, a TPU workaround;
    on CUDA tensors it is one launch of ``grace_compact_words`` (a warp a
    row: popcounts and a warp prefix sum place each word's bits), on CPU
    tensors ``_compact_mask_words_plain`` (``rows`` tiles at a time).

    Returns (ids i32[T, max_q]: the set-bit ids (bit b of word w is id
    w*32+b) in ascending order, the first max_q kept, zero-padded;
    n i32[T] = min(count, max_q); overflow bool[T] = count > max_q).
    """
    if _on_cpu(words):
        return _compact_mask_words_plain(words, max_q, rows)
    return compact_words_cuda(words, max_q)


def compact_words_cuda(words: torch.Tensor, max_q: int):
    """``csrc/broadphase.cu``'s ``grace_compact_words``:
    ``compact_mask_words``'s three outputs."""
    device = _kernels.check_tensors("compact_mask_words", [words], [])
    if words.dim() != 2 or max_q < 0:
        raise ValueError(f"compact_mask_words: words {tuple(words.shape)}, max_q {max_q}")
    n_rows, n_words = words.shape
    words = words.contiguous()
    ids = torch.empty((n_rows, max_q), dtype=torch.int32, device=device)
    n = torch.empty(n_rows, dtype=torch.int32, device=device)
    overflow = torch.empty(n_rows, dtype=torch.bool, device=device)
    _kernels.launch("broadphase", "grace_compact_words", device, words.data_ptr(),
                    ids.data_ptr(), n.data_ptr(), overflow.data_ptr(), n_rows, n_words, max_q)
    compact_words_cuda.launches += 1
    return ids, n, overflow


compact_words_cuda.launches = 0


def compact_words_resources(device, vec: bool = True) -> dict:
    """What one launch of ``grace_compact_words``' kernel holds on
    ``device`` (its 16-byte word loads, or with ``vec`` False the 4-byte
    ones of rows that are no multiple of 4 words): ``_kernels.RESOURCE_FIELDS``
    and ``local_bytes`` a thread."""
    fields = _kernels.RESOURCE_FIELDS + ("local_bytes",)
    out = (ctypes.c_int * len(fields))()
    _kernels.launch("broadphase", "grace_compact_words_resources", torch.device(device),
                    ctypes.addressof(out), int(vec))
    return dict(zip(fields, out))


def _quarter_lists_plain(rays: Rays, spheres, tile: int, max_q: int = 512,
                         seg_block: int = 8192):
    tmin, tmax = _tile_aabbs_plain(rays, tile)
    words = _masks_for_tile_aabbs_plain(tmin, tmax, spheres, seg_block, block=32)
    return _compact_mask_words_plain(words, max_q)


def quarter_lists(rays: Rays, spheres, tile: int, max_q: int = 512,
                  seg_block: int = 8192):
    """Per-tile ascending quarter-id lists (the ``broadphase="qlist"``
    product): quarter-granularity cull, then set-bit compaction. Returns
    (q_ids i32[n_tiles, max_q], n_q i32[n_tiles], overflow bool[n_tiles])."""
    if _on_cpu(spheres):
        return _quarter_lists_plain(rays, spheres, tile, max_q, seg_block)
    tiles, quarters = broadphase_boxes_cuda(rays, tile, spheres, 32)
    return compact_words_cuda(overlap_words_cuda(*tiles, *quarters), max_q)


def _dense_tile_segments_plain(rays: Rays, spheres, tile: int, max_chunks: int):
    tmin, tmax = _tile_aabbs_plain(rays, tile)
    return _compact_mask_words_plain(_masks_for_tile_aabbs_plain(tmin, tmax, spheres),
                                     max_chunks)


def dense_tile_segments(rays: Rays, spheres, tile: int, max_chunks: int):
    """Per-tile ascending, unique 128-primitive segment ids by dense
    culling. Returns (seg_ids i32[n_tiles, max_chunks], n_segs
    i32[n_tiles], overflow bool[n_tiles])."""
    if _on_cpu(spheres):
        return _dense_tile_segments_plain(rays, spheres, tile, max_chunks)
    tiles, segs = broadphase_boxes_cuda(rays, tile, spheres, SEG)
    return compact_words_cuda(overlap_words_cuda(*tiles, *segs), max_chunks)
