"""Perturbation-mask sampling (Configuration Values / KernelSHAP).

Reference: ``src/pathway_explanations/masks.py`` (L4).  Sampling semantics are
reproduced — per-community internal random bits, antithetic external
community coalitions, dead-mask reactivation, the >4000-element budget cap,
and the Shapley fallback — as host-side numpy draws from Philox streams
seeded by the key words of :mod:`..utils.prng`, so the same seed gives the
same masks as the JAX package, bit for bit.

Reference bug fixed by design (SURVEY §7.3): ``masks.py:294`` reads
``self.edge_size`` which never exists, so every edge-problem mask generation
raises ``AttributeError``; here edge problems use the edge count.

Deviation (documented): the reference feeds all sampled rows to a DataLoader
whose last batch may be ragged (``masks.py:196-229``); here rows are trimmed
to ``epochs`` equal batches after shuffling so training is a single
loop over a [epochs, batch, S] tensor.  The dropped remainder is
< ``epochs`` i.i.d. rows out of >=1000.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


class MaskPlan(NamedTuple):
    """Static (host-side) sampling plan for one pathway."""

    pathway_index: int  # index into the original (unsorted) pathway list
    columns: np.ndarray  # sorted element indices of this pathway
    size: int  # rows sampled for this pathway
    size_internal: int  # leading rows that carry only internal bits


def build_plans(
    pathway_inds: Sequence[Sequence[int]], total: int
) -> List[MaskPlan]:
    """Row-budget plan per pathway (reference ``masks.py:313-348``):
    pathways sorted by length descending; ``size = ceil(frac * total)``;
    ``size_internal = ceil(frac * size)`` with the <3 → (1, 2) clamp."""
    lens = np.array([len(p) for p in pathway_inds], np.int64)
    total_len = int(lens.sum())
    order = np.argsort(-lens, kind="stable")
    plans: List[MaskPlan] = []
    for orig_idx in order:
        pathway = sorted(int(v) for v in pathway_inds[orig_idx])
        fraction = len(pathway) / total_len
        size = math.ceil(fraction * total)
        size_internal = math.ceil(fraction * size)
        if size_internal < 3:
            size_internal, size = 1, 2
        plans.append(
            MaskPlan(
                pathway_index=int(orig_idx),
                columns=np.asarray(pathway, np.int32),
                size=size,
                size_internal=size_internal,
            )
        )
    return plans


def _np_rng(key) -> np.random.Generator:
    """Counter-based numpy generator (Philox) seeded from key words (a
    ``[2]`` uint32 array from :mod:`..utils.prng`), or a Generator as is."""
    if isinstance(key, np.random.Generator):
        return key
    words = _key_words(key)
    seed = (int(words[0]) << 32) ^ int(words[-1])
    return np.random.Generator(np.random.Philox(seed))


def _key_words(key) -> np.ndarray:
    """uint64 words of key data (a uint32 numpy array)."""
    return np.asarray(key).astype(np.uint64).ravel()


def _philox_streams(key, n: int) -> List[np.random.Generator]:
    """``n`` independent host-side Philox streams from one key's words."""
    words = _key_words(key)
    k0, k1 = int(words[0]), int(words[-1])
    golden = 0x9E3779B97F4A7C15
    return [
        np.random.Generator(
            np.random.Philox(
                key=np.array(
                    [k0, (k1 ^ (golden * (i + 1))) & 0xFFFFFFFFFFFFFFFF],
                    dtype=np.uint64,
                )
            )
        )
        for i in range(n)
    ]


def _activate_dead_mask(
    rng: np.random.Generator, pm: np.ndarray, ind_pathway: int
) -> np.ndarray:
    """If the whole external mask is False, flip one random community per row
    (reference ``pathways.py:285-334``)."""
    rows, num_pathways = pm.shape
    if num_pathways <= 1 or pm.sum() != 0:
        return pm
    perm = rng.permutation(num_pathways)
    perm = perm[perm != ind_pathway]
    reps = rows // (num_pathways - 1) + 1
    choice = np.tile(perm, reps)[:rows]
    fixed = pm.copy()
    fixed[np.arange(rows), choice] = True
    return fixed


class CommunityLayout(NamedTuple):
    """Draw-independent sampling layout for one (pathways, width, total).

    Everything in the Configuration-Value sampler that does not depend on
    the RNG draws — row budgets, antithetic partner indices, the [P, width]
    membership matrix, and the flat fancy-index arrays that land internal
    bits in own-community columns — precomputed once and reused across
    repeats (``MaskSampler`` caches it per instance).
    """

    num_pathways: int
    num_elements: int
    width: int
    m_total: int
    l_max: int
    starts: np.ndarray      # [U] first row of each used block
    sizes_b: np.ndarray     # [U] rows per used block
    si_b: np.ndarray        # [U] leading internal-only rows per block
    tags_b: np.ndarray      # [U] original pathway index per block
    row_tag: np.ndarray     # [M] original pathway index per row
    is_ext: np.ndarray      # [M] row carries an external coalition
    base: np.ndarray        # [M] antithetic partner source row
    invert: np.ndarray      # [M] row inverts its partner's coalition
    mem_u16: np.ndarray     # [P, width] uint16 membership matrix
    iflat_full: np.ndarray  # [F] flat (row*width + col) internal-bit dests
    iflat_u: np.ndarray     # [F] flat (row*l_max + col_local) uniform srcs
    sub_order: Optional[np.ndarray]  # biggest-first subsample, or None


def build_community_layout(
    pathway_inds: Sequence[Sequence[int]],
    num_elements: int,
    width: int,
    total: int,
) -> CommunityLayout:
    """Build the static Configuration-Value layout, fully vectorized.

    Row budgets follow :func:`build_plans` (reference ``masks.py:313-348``);
    the >4000-element budget cap honours the reference's exact break order —
    the check runs BEFORE the just-appended block is counted
    (``masks.py:343-348``: ``if cumulative_size > ...: break`` precedes
    ``cumulative_size += mask.shape[0]``), asserted in tests/test_masks.py.
    """
    num_pathways = len(pathway_inds)
    lens_all = np.array([len(p) for p in pathway_inds], np.int64)
    total_len = max(int(lens_all.sum()), 1)
    order = np.argsort(-lens_all, kind="stable")
    frac = lens_all[order].astype(np.float64) / total_len
    sizes = np.ceil(frac * total).astype(np.int64)
    si = np.ceil(frac * sizes).astype(np.int64)
    clamp = si < 3
    si[clamp] = 1
    sizes[clamp] = 2

    # budget cap: biggest pathways only; block i is the last appended when
    # sum(sizes[:i]) > total first holds
    nused = num_pathways
    if num_elements > 4000 and num_pathways:
        cum_before = np.zeros(num_pathways, np.int64)
        np.cumsum(sizes[:-1], out=cum_before[1:])
        over = np.nonzero(cum_before > total)[0]
        if over.size:
            nused = int(over[0]) + 1
    sizes_b = sizes[:nused]
    si_b = si[:nused]
    tags_b = order[:nused].astype(np.int32)
    lens_b = lens_all[order[:nused]].astype(np.int32)
    m_total = int(sizes_b.sum())
    starts = np.zeros(nused, np.int64)
    np.cumsum(sizes_b[:-1], out=starts[1:])

    # [P, width] membership over ALL pathways (coalition bits may include
    # any community, used or not): one flat fancy assignment
    mem = np.zeros((num_pathways, width), np.uint16)
    if total_len:
        flat_cols = np.concatenate(
            [np.asarray(p, np.int64) for p in pathway_inds]
        ) if num_pathways else np.zeros(0, np.int64)
        mem[np.repeat(np.arange(num_pathways), lens_all), flat_cols] = 1

    rows = np.arange(m_total)
    row_block = np.repeat(np.arange(nused), sizes_b)
    row_tag = tags_b[row_block]
    local = rows - starts[row_block]
    is_ext = local >= si_b[row_block]
    j = local - si_b[row_block]
    half = ((sizes_b - si_b) // 2)[row_block]
    # antithetic external coalitions: second half inverts the first half
    # (reference pathways.py:234-283); odd tail row is a fresh draw
    invert = is_ext & (j >= half) & (j < 2 * half)
    base = np.where(invert, rows - half, rows)

    # internal bits: draws cover only the max community width (communities
    # are typically width/P columns wide).  Destination (row, col) pairs for every
    # block flattened into ONE fancy assignment: row r of block b writes its
    # block's sorted columns from u_elem[r, :len_b]
    l_max = int(lens_b.max()) if nused else 0
    colcat = (
        np.concatenate([np.sort(np.asarray(pathway_inds[t], np.int64))
                        for t in tags_b])
        if nused else np.zeros(0, np.int64)
    )
    col_off = np.zeros(nused, np.int64)
    if nused:
        np.cumsum(lens_b[:-1], out=col_off[1:])
    lens_per_row = lens_b[row_block].astype(np.int64)
    f_total = int(lens_per_row.sum())
    row_flat = np.repeat(rows, lens_per_row)
    ends = np.cumsum(lens_per_row)
    col_local = np.arange(f_total) - np.repeat(ends - lens_per_row,
                                               lens_per_row)
    col_flat = colcat[col_off[row_block[row_flat]] + col_local]
    iflat_full = row_flat * width + col_flat
    iflat_u = row_flat * max(l_max, 1) + col_local

    sub_order = None
    if num_elements > 4000 and m_total > total:
        # biggest-communities-first subsample (masks.py:367-380)
        sub_order = np.argsort(-lens_b[row_block], kind="stable")[:total]
    return CommunityLayout(
        num_pathways=num_pathways, num_elements=num_elements, width=width,
        m_total=m_total, l_max=l_max, starts=starts, sizes_b=sizes_b,
        si_b=si_b, tags_b=tags_b, row_tag=row_tag, is_ext=is_ext, base=base,
        invert=invert, mem_u16=mem, iflat_full=iflat_full, iflat_u=iflat_u,
        sub_order=sub_order,
    )


def draw_community_mask(
    layout: CommunityLayout, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """One Configuration-Value draw over a precomputed layout.

    Semantics (internal bits / antithetic external coalitions / dead-mask
    reactivation / budget cap / biggest-first subsample) match the reference
    block loop (``masks.py:322-348``) — asserted by the coalition-validity
    tests.  Two uniform tensors cover all rows; everything else is the
    layout's precomputed index arithmetic.
    """
    m_total, num_pathways = layout.m_total, layout.num_pathways
    u_elem = rng.random((m_total, max(layout.l_max, 1)), dtype=np.float32)
    u_path = rng.random((m_total, num_pathways), dtype=np.float32)

    pm = (u_path[layout.base] < 0.5) ^ layout.invert[:, None]
    pm[~layout.is_ext] = False
    if num_pathways > 1:
        pm[np.arange(m_total), layout.row_tag] = False  # own community out
    else:
        pm[:] = False  # no external coalitions with a single community

    if num_pathways > 1:
        # dead-mask reactivation (reference pathways.py:285-334): when a
        # block's whole external mask is all-False, flip one random other
        # community per row.  All-False needs every bit of a
        # [rows_ext, P-1] draw to land False — vanishingly rare, so detection
        # is one bincount and only affected blocks loop.
        row_any = pm.any(axis=1)
        ext_rows = layout.sizes_b - layout.si_b
        live = np.bincount(
            np.repeat(np.arange(layout.starts.size), layout.sizes_b)[
                layout.is_ext & row_any
            ],
            minlength=layout.starts.size,
        )
        for bi in np.nonzero((ext_rows > 0) & (live == 0))[0]:
            s = int(layout.starts[bi] + layout.si_b[bi])
            e = int(layout.starts[bi] + layout.sizes_b[bi])
            pm[s:e] = _activate_dead_mask(
                rng, pm[s:e], int(layout.tags_b[bi])
            )

    # community coalition -> element bits: one matmul (elements in several
    # coalition communities OR together, like the reference's scatter-or).
    # uint16 accumulator: a uint8 matmul would wrap to 0 for an element
    # shared by a multiple of 256 coalition communities (P >= 256 pathways)
    full = pm.astype(np.uint16) @ layout.mem_u16 > 0
    # own-community columns carry the internal bits (reference
    # masks.py:322-340): one flat fancy assignment over precomputed indices
    full.reshape(-1)[layout.iflat_full] = (
        u_elem.reshape(-1)[layout.iflat_u] < 0.5
    )

    tags = layout.row_tag
    if layout.sub_order is not None:
        full = full[layout.sub_order]
        tags = tags[layout.sub_order]
    return full, tags


def sample_community_mask(
    key,
    pathway_inds: Sequence[Sequence[int]],
    num_elements: int,
    width: int,
    total: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full Configuration-Value mask — vectorized across pathways.

    Returns (mask [M, width] bool, pathway_rows [M] int32) where M = sum of
    per-pathway row budgets and ``pathway_rows[r]`` is the original index of
    the pathway whose internal bits occupy row r (reference
    ``masks.py:340-360``).  The >4000-element early break is honoured.

    The reference builds this block-by-block in a Python loop with per-block
    draws (``masks.py:322-348``).  This is :func:`build_community_layout` (static index arithmetic)
    + :func:`draw_community_mask` (two uniform tensors, one membership
    matmul, one flat internal-bit assignment); repeat callers should build
    the layout once and call :func:`draw_community_mask` per key
    (``MaskSampler`` does).  ``key`` may be key data or a numpy Generator.
    """
    layout = build_community_layout(pathway_inds, num_elements, width, total)
    return draw_community_mask(layout, _np_rng(key))


def sample_shapley_mask(
    key, num_elements: int, width: int, total: int
) -> np.ndarray:
    """Fully random mask for Shapley-value mode (reference
    ``masks.py:231-260``); padding columns beyond ``num_elements`` stay
    False.  ``key`` may be key data or a numpy Generator."""
    bits = _np_rng(key).random((total, width), dtype=np.float32) < 0.5
    bits[:, num_elements:] = False
    return bits


class MaskSampler:
    """Mask generation front-end (reference ``Mask`` class, ``masks.py:10``).

    Params
    ------
    num_elements : actual number of elements to explain (sub-graph nodes or
        edges)
    width : static padded mask width (>= num_elements)
    params : hyperparameter dict with ``interpret_samples`` and ``epochs``
        (reference ``config/configs.json``)
    pathway_inds : communities as element-index lists, or None for Shapley
        mode
    """

    def __init__(
        self,
        num_elements: int,
        width: int,
        params: dict,
        pathway_inds: Optional[Sequence[Sequence[int]]] = None,
    ):
        n_perturbs = params["interpret_samples"]
        epochs = params["epochs"]
        if not isinstance(n_perturbs, (int, float)) or isinstance(n_perturbs, bool):
            raise TypeError("interpret_samples is not numeric")
        if not isinstance(epochs, (int, float)) or isinstance(epochs, bool):
            raise TypeError("epochs is not numeric")
        n_perturbs = abs(n_perturbs)
        epochs = abs(epochs)
        self.num_elements = int(num_elements)
        self.width = int(width)
        self.n_perturbs = int(n_perturbs)
        self.epochs = int(epochs)
        self.total = self.n_perturbs * self.epochs
        self.pathway_inds = pathway_inds
        self._layout: Optional[CommunityLayout] = None  # built lazily

    def sample(self, key) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
        """Returns (mask [M_used, width], pathway_rows or None, batch_size)
        with rows shuffled and trimmed to ``epochs`` equal batches.

        Entirely host-side numpy, deterministically derived from the key
        data ``key`` (see :func:`_philox_streams`).
        """
        rng_mask, rng_perm = _philox_streams(key, 2)
        if self.pathway_inds is not None:
            if self._layout is None:
                self._layout = build_community_layout(
                    self.pathway_inds, self.num_elements, self.width,
                    self.total,
                )
            mask, tags = draw_community_mask(self._layout, rng_mask)
        else:
            mask = sample_shapley_mask(rng_mask, self.num_elements, self.width, self.total)
            tags = None

        m_total = mask.shape[0]
        perm = rng_perm.permutation(m_total)
        mask = mask[perm]
        if tags is not None:
            tags = tags[perm]

        batch_size = max(m_total // self.epochs, 1)
        m_used = batch_size * min(self.epochs, m_total)
        mask = mask[:m_used]
        if tags is not None:
            tags = tags[:m_used]
        return mask, tags, batch_size
