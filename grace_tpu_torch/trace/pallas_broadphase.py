"""Dense segment culling broadphase (PyTorch counterpart of
``grace_tpu.trace.pallas_broadphase``).

Every ray tile's AABB is tested against every ``block``-primitive segment
of the Morton-sorted particle array, and the overlaps are packed into i32
bitmask words (bit s of word w = segment w*32+s). Segments are processed
``seg_block`` at a time, so the dense bool matrix is never larger than
n_tiles x seg_block. ``compact_mask_words`` turns words into per-tile
ascending id lists (``quarter_lists``, ``dense_tile_segments``). Words,
summaries and lists are bit-exact with ``grace_tpu``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from grace_tpu_torch.core.types import Rays
from grace_tpu_torch.ops.primitives import sphere_aabb
from grace_tpu_torch.trace.broadphase import tile_aabbs

SEG = 128
_F32_MAX = torch.finfo(torch.float32).max


def segment_aabbs(spheres: torch.Tensor, block: int = SEG
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABBs of each ``block``-primitive segment of the sorted particle
    array, padded to a SEG multiple with empty boxes. ``block`` divides SEG."""
    n = spheres.shape[0]
    n_pad = ((n + SEG - 1) // SEG) * SEG
    mins, maxs = sphere_aabb(spheres)
    pad = lambda a, v: torch.cat([a, a.new_full((n_pad - n, 3), v)])
    seg_min = pad(mins, _F32_MAX).reshape(-1, block, 3).amin(dim=1)
    seg_max = pad(maxs, -_F32_MAX).reshape(-1, block, 3).amax(dim=1)
    return seg_min, seg_max


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


def masks_for_tile_aabbs(tmin, tmax, spheres, seg_block: int = 8192,
                         block: int = SEG) -> torch.Tensor:
    """Overlap words of precomputed ray-tile AABBs against ``block``-
    primitive segments, ``seg_block`` segments at a time."""
    seg_min, seg_max = segment_aabbs(spheres, block=block)

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


def dense_tile_masks(rays: Rays, spheres, tile: int, seg_block: int = 8192):
    """Seg-128 bitmask broadphase: i32[n_tiles, ceil(n_segs/32)] words."""
    tmin, tmax = tile_aabbs(rays, tile)
    return masks_for_tile_aabbs(tmin, tmax, spheres, seg_block)


def dense_tile_masks_quarter(rays: Rays, spheres, tile: int, seg_block: int = 8192):
    """Quarter-granularity (32-primitive) bitmask broadphase. Returns

      words   i32[n_tiles, ceil(n_q / 32)]     bit q of word w = quarter
                                               w*32+q overlaps the tile box
      summary i32[n_tiles, ceil(words / 32)]   bit w of summary word s =
                                               word s*32+w is nonzero
    """
    tmin, tmax = tile_aabbs(rays, tile)
    words = masks_for_tile_aabbs(tmin, tmax, spheres, seg_block, block=32)
    summary = pack_overlap_bits(words != 0)
    return words, summary


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of i32 words (SWAR, on the unsigned value)."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def compact_mask_words(words: torch.Tensor, max_q: int, rows: int = 1024):
    """Set-bit compaction of bitmask words into per-tile id lists.

    ``grace_tpu``'s form is gather-free one-hot matmuls, a TPU workaround;
    here the bits are unpacked and each set bit is scattered to its rank
    (a running count along the row), ``rows`` tiles at a time to bound the
    [rows, n_words * 32] intermediates.

    Returns (ids i32[T, max_q]: the set-bit ids (bit b of word w is id
    w*32+b) in ascending order, the first max_q kept, zero-padded;
    n i32[T] = min(count, max_q); overflow bool[T] = count > max_q).
    """
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


def quarter_lists(rays: Rays, spheres, tile: int, max_q: int = 512,
                  seg_block: int = 8192):
    """Per-tile ascending quarter-id lists (the ``broadphase="qlist"``
    product): quarter-granularity cull, then set-bit compaction. Returns
    (q_ids i32[n_tiles, max_q], n_q i32[n_tiles], overflow bool[n_tiles])."""
    tmin, tmax = tile_aabbs(rays, tile)
    words = masks_for_tile_aabbs(tmin, tmax, spheres, seg_block, block=32)
    return compact_mask_words(words, max_q)


def dense_tile_segments(rays: Rays, spheres, tile: int, max_chunks: int):
    """Per-tile ascending, unique 128-primitive segment ids by dense
    culling. Returns (seg_ids i32[n_tiles, max_chunks], n_segs
    i32[n_tiles], overflow bool[n_tiles])."""
    tmin, tmax = tile_aabbs(rays, tile)
    words = masks_for_tile_aabbs(tmin, tmax, spheres)
    return compact_mask_words(words, max_chunks)
