"""Batched multi-query explanation (the explanations/sec path).

The reference explains exactly one element per ``run()`` (a Python loop of
repeats around torch training, ``explainer.py:490-519``).  Serving wants
*many* queries explained at once.  Here the whole per-query pipeline (mask
draws, masked black-box forwards, KernelSHAP weighting, surrogate Adam
training) runs over a stack of Q budget-padded computational subgraphs: every
operation carries the query axis, so one pass of device work explains Q
queries.

Three forward formulations, chosen per (model, problem):

* **dense**: homogeneous :class:`..models.gnn.GCNNodeModel` node problems,
  the mask-scaled dense-adjacency forward over a ``[Q, n, n]`` stack (the
  throughput path; plain batched matmuls).
* **hetero_dense**: node problems of a :class:`..models.gnn.HeteroGNN`
  whose convs are all default GCNConvs: the same forward per relation over
  ``[Q, R, n, n]`` adjacencies, each relation's self-loops and bias on its
  destination type only (PyG ``HeteroConv`` with ``aggr='sum'``).
* **coo**: everything else (edge and graph problems, hetero models with
  other convs, such as the hetero SAGE and GAT stacks, the other model
  families): the stacked subgraphs stay in
  COO form and the model's own forward runs with per-sample edge weights,
  the Q subgraphs side by side as one block-diagonal graph, with their node
  and edge types where the model is typed.

A hetero graph's type ids are positions, as in the JAX package: node type
``i`` is ``model_def.node_type_names[i]`` and edge type ``ri`` is
``model_def.relations[ri]`` (what :func:`..graph.hetero_to_homo` gives when
the feature and edge dicts follow the model's order).  Ids outside the
model's lists raise ``ValueError``; matching types by name is the
``Explainer``'s, which has the names.

Loss-normalisation parity: in community mode each query's rows are laid out
``[epochs, bs_q]`` exactly as the single-query ``Explainer`` batches them,
then the batch axis is padded to the stack-wide maximum with all-False rows.
The weighted MSE divides by the *real* batch size ``bs_q``, and the kernel
weight of a pad row is 0, so every Adam step sees ``Explainer``'s numerics.

Every key derives from ``params['seed']`` as in the JAX package: ``fold_in(
fold_in(PRNGKey(seed), repeat), original query position)``, then
``fold_in(key, 0)`` for the Shapley mask draw (made on the model's device,
:func:`..utils.prng.bernoulli_tensor`) and ``fold_in(key, 1)`` for the
surrogate's initialisation.  So the same seed gives the JAX package's
``explain_many`` scores.

Not ported: ``mesh=`` (raises ``NotImplementedError``).  A typed model
that is not a HeteroGNN (:class:`..models.gnn.RGCNNodeModel`) raises
``TypeError``, as the JAX package's ``explain_many`` does.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..graph import Graph, host_view
from ..models.fast_gcn import dense_gcn_layers, dense_mask_scales
from ..models.fast_hetero import (
    dense_hetero_gcn_layers, dense_hetero_mask_scales, is_hetero_gcn,
)
from ..models.gnn import GCNNodeModel, HeteroGNN
from ..ops.khop import Subgraph, extract_khop_subgraph
from ..utils import prng
from ..utils.padding import round_up_pow2
from .explainer import Explanation
from .masks import MaskSampler, build_community_layout
from .pathways import segment_means, segment_table


@lru_cache(maxsize=256)
def _folded_keys_cached(seed: int, times: int, pos: tuple) -> np.ndarray:
    """Key data of ``fold_in(fold_in(PRNGKey(seed), t), p)`` for every
    repeat ``t`` and position ``p``: ``[T, Q, 2]`` uint32 (read-only),
    memoised by value."""
    root = prng.root_key(seed)
    pos_arr = np.asarray(pos, np.int64).astype(np.uint32)
    out = np.empty((times, len(pos), 2), np.uint32)
    for t in range(times):
        y0, y1 = prng.threefry2x32(
            prng.fold_in(root, t), np.zeros(len(pos), np.uint32), pos_arr
        )
        out[t, :, 0], out[t, :, 1] = y0, y1
    out.setflags(write=False)
    return out


def _filter_pathways_to_subgraph(
    pw_global: List[np.ndarray],
    pw_names: Sequence,
    parents: np.ndarray,
    cap: int,
):
    """Integer-space community filtering for one subgraph.

    Equivalent to ``Pathways.comp_graph`` + ``names2inds`` (reference
    ``pathways.py:33-136``) but on precomputed global element ids: build a
    global->local slot map once and gather each community through it, with
    no per-query string ``intersect1d``.  Communities with no member in the
    subgraph drop, like the reference's.
    """
    loc = np.full((cap,), -1, np.int64)
    loc[parents] = np.arange(parents.shape[0])
    sub_inds, kept_names = [], []
    for pj, pg in enumerate(pw_global):
        li = loc[pg]
        li = li[li >= 0]
        if li.size:
            sub_inds.append(li.tolist())
            kept_names.append(pw_names[pj])
    return sub_inds, kept_names


def _seed_nodes(graph, queries, problem):
    """BFS seed node per query: the query itself for node/graph problems,
    the query edge's RECEIVER for edge problems (its prediction is what the
    masked forwards read; fixed by design, see ``Explainer._explain``)."""
    if "edge" not in problem:
        return [int(q) for q in queries]
    rcv = host_view(graph).receivers
    return [int(rcv[int(q)]) for q in queries]


_NO_NAMES = object()  # sentinel key for names=None


def _seq_fp(seq) -> int:
    """Hash one flat sequence's content (ndarray bytes or element tuple)."""
    if isinstance(seq, np.ndarray):
        return hash(seq.tobytes())
    try:
        return hash(tuple(seq))
    except TypeError:  # unhashable elements (e.g. nested lists)
        return hash(tuple(str(v) for v in seq))


def _content_fp(obj) -> int:
    """Cheap content fingerprint for the identity-keyed serving caches.

    Identity alone cannot detect an *in-place* mutation of a still-live
    pathways/names list (same object, changed content); this hashes the
    content: flat sequences hash every element, nested sequences
    (communities) hash per-community content.
    """
    if obj is None or obj is _NO_NAMES:
        return 0
    if isinstance(obj, np.ndarray):
        return hash(obj.tobytes())
    if len(obj) and isinstance(obj[0], (list, tuple, np.ndarray)):
        return hash(tuple(_seq_fp(p) for p in obj))
    return _seq_fp(obj)


_PW_GLOBAL_CACHE: OrderedDict = OrderedDict()


def _pathways_global_ids_cached(pathways, names_arr: np.ndarray, names_src):
    """Identity+content-cached name->global-id community conversion.

    Keyed by the *source* objects' ids; the cache holds strong references
    to those objects, so a live entry's ids can never be recycled.  A
    content fingerprint (:func:`_content_fp`) is validated on every hit, so
    an in-place mutation of a cached list is recomputed rather than served
    stale.  Bounded FIFO of 4 entries.  ``names_src`` is the caller's
    ``names`` argument (or :data:`_NO_NAMES` when element names default to
    indices, in which case the padded width disambiguates).
    """
    key = (id(pathways), id(names_src), len(names_arr))
    fp = (_content_fp(pathways), _content_fp(names_arr))
    hit = _PW_GLOBAL_CACHE.get(key)
    if hit is not None and hit[0] is pathways and hit[1] is names_src and hit[3] == fp:
        return hit[2]
    val = _pathways_as_global_ids(pathways, names_arr)
    _PW_GLOBAL_CACHE[key] = (pathways, names_src, val, fp)
    while len(_PW_GLOBAL_CACHE) > 4:
        _PW_GLOBAL_CACHE.popitem(last=False)
    return val


_QUERY_COMM_CACHE: OrderedDict = OrderedDict()


def _community_query_cached(
    graph, pathways, names_src, query, parents, ne, width, total,
    pw_global, pw_names_list, cap, content_fp=None,
):
    """Per-(graph, pathways, names, query) community statics, cached.

    The subgraph pathway filter, the sampling :class:`~.masks.
    CommunityLayout` and the score segment table are draw-independent.
    Same strong-ref FIFO identity pattern as
    :func:`_pathways_global_ids_cached` (512 entries); the parents hash
    guards against key collisions across hop depths, and ``content_fp``
    (the caller's :func:`_content_fp` of the pathway/name content) is
    validated on hit so in-place mutations are never served stale.
    """
    parents = np.asarray(parents)
    key = (
        id(graph), id(pathways), id(names_src), int(query), int(ne),
        int(width), int(total), hash(parents.tobytes()),
    )
    hit = _QUERY_COMM_CACHE.get(key)
    if (
        hit is not None
        and hit[0] is graph
        and hit[1] is pathways
        and (content_fp is None or hit[4] == content_fp)
    ):
        return hit[3]
    sub_inds, sub_pw_names = _filter_pathways_to_subgraph(
        pw_global, pw_names_list, parents.astype(np.int64), cap
    )
    entry = {
        "sub_inds": sub_inds,
        "sub_pw_names": sub_pw_names,
        "layout": build_community_layout(sub_inds, ne, width, total),
        "seg": segment_table(sub_inds),
    }
    _QUERY_COMM_CACHE[key] = (graph, pathways, names_src, entry, content_fp)
    while len(_QUERY_COMM_CACHE) > 512:
        _QUERY_COMM_CACHE.popitem(last=False)
    return entry


def _pathways_as_global_ids(pathways, names_arr: np.ndarray) -> List[np.ndarray]:
    """Communities as sorted unique global element-id arrays (name lookups
    through one argsort of the name table and a searchsorted per community;
    unknown names drop, like the reference's ``intersect1d``)."""
    if len(pathways) and len(pathways[0]) and isinstance(pathways[0][0], (int, np.integer)):
        return [np.asarray(sorted({int(v) for v in pw}), np.int64) for pw in pathways]
    order = np.argsort(names_arr, kind="stable")
    sorted_names = names_arr[order]
    out = []
    for pw in pathways:
        arr = np.asarray(pw).astype(names_arr.dtype)
        pos = np.clip(np.searchsorted(sorted_names, arr), 0, len(sorted_names) - 1)
        ok = sorted_names[pos] == arr
        out.append(np.unique(order[pos[ok]]).astype(np.int64))
    return out


_SUBGRAPH_CACHE: OrderedDict = OrderedDict()


def _subgraph_cached(graph: Graph, seed: int, n_hops: int) -> Subgraph:
    """Identity-cached host-only k-hop subgraph extraction for serving
    loops: a query's computational subgraph is a pure function of (graph,
    seed node, hop count), and graphs are never mutated in place.
    Strong-ref FIFO of 4096 entries."""
    key = (id(graph), int(seed), int(n_hops))
    hit = _SUBGRAPH_CACHE.get(key)
    if hit is not None and hit[0] is graph:
        return hit[1]
    sub = extract_khop_subgraph(graph, int(seed), n_hops, host_only=True)
    _SUBGRAPH_CACHE[key] = (graph, sub)
    while len(_SUBGRAPH_CACHE) > 4096:
        _SUBGRAPH_CACHE.popitem(last=False)
    return sub


# ---------------------------------------------------------------------------
# subgraph stacking
# ---------------------------------------------------------------------------


class _Stack:
    """Host-side stack of Q budget-padded computational subgraphs, each
    padded to the stack's largest pow2 node and edge budget.

    ``need_edges``: keep the COO arrays only (the coo formulation); else
    build the dense adjacencies ``adjs [Q, n, n]`` (``adjs[q, v, u]`` counts
    the non-loop edges u -> v), or with ``rel_model`` (a
    :class:`..models.gnn.HeteroGNN`) one per relation, ``adjs_r [Q, R, n,
    n]`` (relation ``ri``'s non-loop edges), with each relation's
    destination-type scope ``scopes [Q, R, n]`` (1.0 on valid nodes of the
    type ``rel[-1]``).  ``typed``: also keep the node and edge type ids
    ``ntype [Q, n]`` and ``etype [Q, e]`` (padding has type 0).
    ``full_graph``: graph problems explain the pooled prediction of the
    WHOLE graph, so every "query" is an independent repeat over it.
    """

    def __init__(self, graph: Graph, queries: Sequence[int], n_hops: int,
                 need_edges: bool, typed: bool = False, full_graph: bool = False,
                 subs: Optional[list] = None, rel_model=None):
        if subs is None and full_graph:
            hv = host_view(graph)
            subs = [
                Subgraph(graph=graph, parent_nodes=np.arange(graph.n_pad),
                         query=0, parent_edge_mask=np.asarray(hv.edge_mask))
                for _ in queries
            ]
        elif subs is None:
            subs = [
                extract_khop_subgraph(graph, int(q), n_hops, host_only=True)
                for q in queries  # already seed NODES (see _seed_nodes)
            ]
        n_pad = max(round_up_pow2(s.graph.num_nodes) for s in subs)
        e_pad = max(max(round_up_pow2(s.graph.num_edges), 8) for s in subs)
        qn = len(subs)
        self.n_pad, self.e_pad, self.qn = n_pad, e_pad, qn

        self.xs = np.zeros((qn, n_pad, graph.num_features), np.float32)
        self.adjs = (
            None if need_edges or rel_model is not None
            else np.zeros((qn, n_pad, n_pad), np.float32)
        )
        self.adjs_r = self.scopes = None
        if rel_model is not None:
            nrel = len(rel_model.relations)
            self.adjs_r = np.zeros((qn, nrel, n_pad, n_pad), np.float32)
            self.scopes = np.zeros((qn, nrel, n_pad), np.float32)
            dst_types = [rel_model.node_type_names.index(r[-1]) for r in rel_model.relations]
        self.ntype = np.zeros((qn, n_pad), np.int64) if typed else None
        self.etype = np.zeros((qn, e_pad), np.int64) if typed else None
        self.snds = np.zeros((qn, e_pad), np.int64)
        self.rcvs = np.zeros((qn, e_pad), np.int64)
        self.evalid = np.zeros((qn, e_pad), np.float32)
        self.qidx = np.zeros((qn,), np.int64)
        self.nvalid = np.zeros((qn,), np.int64)
        self.evalid_count = np.zeros((qn,), np.int64)
        self.parent_nodes: List[np.ndarray] = []
        self.parent_edges: List[np.ndarray] = []
        for i, s in enumerate(subs):
            g = s.graph
            n, e = g.num_nodes, g.num_edges
            hv = host_view(g)
            self.xs[i, :n] = hv.x[:n]
            snd = hv.senders[:e]
            rcv = hv.receivers[:e]
            self.snds[i, :e] = snd
            self.rcvs[i, :e] = rcv
            self.evalid[i, :e] = 1.0
            keep = snd != rcv
            if typed:
                self.ntype[i, :n] = hv.node_type[:n]
                self.etype[i, :e] = hv.edge_type[:e]
            if self.adjs is not None:
                np.add.at(self.adjs[i], (rcv[keep], snd[keep]), 1.0)
            if self.adjs_r is not None:
                et, nt, valid = hv.edge_type[:e], hv.node_type[:n], hv.node_mask[:n]
                for ri, dt in enumerate(dst_types):
                    sel = keep & (et == ri)
                    np.add.at(self.adjs_r[i, ri], (rcv[sel], snd[sel]), 1.0)
                    self.scopes[i, ri, :n] = (nt == dt) & valid
            self.qidx[i] = s.query
            self.nvalid[i] = n
            self.evalid_count[i] = e
            self.parent_nodes.append(np.asarray(s.parent_nodes)[:n])
            self.parent_edges.append(np.nonzero(np.asarray(s.parent_edge_mask))[0])


# ---------------------------------------------------------------------------
# kernel + surrogate (shared by both formulations), batched over queries
# ---------------------------------------------------------------------------


def _unpack_mask_bits(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of ``np.packbits(mask, axis=-1)`` on the device.

    Community masks are sampled on the host and shipped packed, 8 mask
    bits per byte.  ``packed``: ``[..., ceil(width/8)]`` uint8, big-endian
    bit order (numpy's default).  Returns ``[..., width]`` bool.
    """
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :width].bool()


def _masks_in(masks: Optional[torch.Tensor], width: int) -> Optional[torch.Tensor]:
    """Accept either raw bool masks or packbits-compressed uint8 rows.

    A uint8 input is only treated as bit-packed when its trailing dim is
    ``ceil(width/8)`` and differs from ``width``; a genuine ``[..., width]``
    0/1 uint8 array is cast to bool instead of being misread as packed.
    """
    if masks is not None and masks.dtype == torch.uint8:
        packed_cols = -(-width // 8)
        if masks.shape[-1] == packed_cols and packed_cols != width:
            return _unpack_mask_bits(masks, width)
        return masks.bool()
    return masks


def _kernel_weights(masks: torch.Tensor, n_elements: torch.Tensor) -> torch.Tensor:
    """Log-space KernelSHAP weights ``[Q, M]`` of masks ``[Q, M, W]`` with a
    per-query element count ``[Q]`` (the mask width is padded; all-False pad
    rows get weight 0), max-normalised over each query's rows."""
    k = masks.sum(-1).to(torch.float32)
    nv = n_elements.to(torch.float32)[:, None] - 1.0
    logw = (
        torch.log(torch.clamp(nv, min=1e-30))
        - (torch.lgamma(nv + 2.0) - torch.lgamma(k + 1.0) - torch.lgamma(nv + 2.0 - k))
        - torch.log(torch.clamp(nv + 1.0 - k, min=1e-30))
        - torch.log(torch.clamp(k, min=1e-30))
    )
    valid = (k >= 1.0) & (k <= nv)
    safe = torch.where(valid, logw, torch.full_like(logw, -torch.inf))
    safe = torch.where(torch.isfinite(safe), safe, torch.full_like(safe, -1e30))
    logw = logw - safe.amax(-1, keepdim=True)
    return torch.where(valid, torch.exp(logw), torch.zeros_like(logw))


def _train(masks, outputs, kern, keys, n_elements, col_valid, epochs: int,
           bs_real, lr: float, l1: float, wd: float) -> torch.Tensor:
    """Adam on Q weighted linear surrogates at once; returns the best-loss
    weights ``[Q, W]``.

    masks ``[Q, M, W]`` bool, outputs and kern ``[Q, M]``, keys ``[Q, 2]``
    int64 (the init keys), n_elements and bs_real ``[Q]``, col_valid
    ``[Q, W]`` bool.  Not :func:`.wlm.train_surrogate`: the initialisation
    is ``U(-1, 1) / sqrt(n)``, the weighted MSE divides by the *real* rows
    per batch ``bs_real`` (pad rows carry kernel weight 0), and the L1 term
    uses each query's own element count.
    """
    q, n_masks, width = masks.shape
    bs = n_masks // epochs
    f32 = torch.float32
    maskf = masks.to(f32).reshape(q, epochs, bs, width)
    y = outputs.reshape(q, epochs, bs)
    kb = kern.reshape(q, epochs, bs)
    nf = n_elements.to(f32)
    colf = col_valid.to(f32)
    w = prng.uniform_tensor(keys, width, -1.0, 1.0) * torch.rsqrt(nf)[:, None] * colf
    bs_f = bs_real.to(f32)
    l1_scale = (l1 / nf)[:, None] * colf  # d/dw of the L1 term is sign(w) * this
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)
    best_w = w
    best_loss = torch.full((q,), torch.inf, dtype=f32, device=w.device)
    step = torch.zeros((), dtype=f32, device=w.device)
    b1 = torch.tensor(0.9, dtype=f32, device=w.device)
    b2 = torch.tensor(0.999, dtype=f32, device=w.device)
    for e in range(epochs):
        mb, yb, kbb = maskf[:, e], y[:, e], kb[:, e]
        pred = torch.bmm(mb, w[:, :, None])[:, :, 0]
        r = pred - yb
        ksum = torch.clamp(kbb.sum(-1), min=1e-30)
        loss = (kbb * r * r).sum(-1) / bs_f / ksum + l1 * (w.abs() * colf).sum(-1) / nf
        # d loss / d w, in the order reverse-mode autodiff takes it
        g_pred = (kbb * ((1.0 / ksum) / bs_f)[:, None]) * (2.0 * r)
        g = torch.bmm(mb.transpose(1, 2), g_pred[:, :, None])[:, :, 0]
        g = g + torch.sign(w) * l1_scale
        g = (g + wd * w) * colf
        step = step + 1.0
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        w = w - lr * (m / (1.0 - torch.pow(b1, step))) / (
            torch.sqrt(v / (1.0 - torch.pow(b2, step))) + 1e-8
        )
        improved = loss < best_loss
        best_w = torch.where(improved[:, None], w, best_w)
        best_loss = torch.where(improved, loss, best_loss)
    return best_w


# ---------------------------------------------------------------------------
# the three forward formulations, over the query axis
# ---------------------------------------------------------------------------


def _dense_outputs(model_def: GCNNodeModel, x, adj, query, masks, chunk: int) -> torch.Tensor:
    """Dense mask-scaled GCN forward (homogeneous node problems): the query
    rows' outputs ``[Q, M]`` for masks ``[Q, M, n]`` over adjacencies
    ``[Q, n, n]`` and features ``[Q, n, F]``, ``chunk`` rows at a time,
    through the single-graph dense tier's layers
    (:func:`..models.fast_gcn.dense_gcn_layers`) with the query axis leading.
    """
    nq, n_masks, _ = masks.shape
    conv0 = model_def.conv[0]
    xw0 = x[..., : conv0.in_features] @ conv0.weight.T  # [Q, n, C]
    qi = torch.arange(nq, device=x.device)
    outs = []
    for c0 in range(0, n_masks, chunk):
        m = masks[:, c0 : c0 + chunk].to(torch.float32).transpose(1, 2)  # [Q, n, B]
        s, self_w = dense_mask_scales(adj, m)
        # the [Q, n, B, C] activations die here, before the next chunk's
        h_query = dense_gcn_layers(adj, s, self_w, xw0, model_def.conv)[qi, query]
        outs.append(model_def.head(h_query)[..., 0])  # [Q, B]
    return torch.cat(outs, dim=1)


def _hetero_dense_outputs(model_def: HeteroGNN, x, adj_r, scope, query, masks,
                          chunk: int) -> torch.Tensor:
    """Dense mask-scaled forward of a hetero GCN (node problems): the query
    rows' outputs ``[Q, M]`` for masks ``[Q, M, n]`` over per-relation
    adjacencies ``adj_r [Q, R, n, n]``, destination-type scopes ``scope
    [Q, R, n]`` and features ``[Q, n, F]``, ``chunk`` rows at a time,
    through the hetero engine's dense layers
    (:func:`..models.fast_hetero.dense_hetero_gcn_layers`) with the query
    axis leading.
    """
    nq, n_masks, _ = masks.shape
    # the first layer's transformed features, shared by every mask
    xw0 = [x[..., : c.in_features] @ c.weight.T for c in model_def.conv_layers[0].values()]
    qi = torch.arange(nq, device=x.device)
    outs = []
    for c0 in range(0, n_masks, chunk):
        m = masks[:, c0 : c0 + chunk].to(torch.float32).transpose(1, 2)  # [Q, n, B]
        s, self_w = dense_hetero_mask_scales(adj_r, scope, m)
        # the [Q, n, B, C] activations die here, before the next chunk's
        h_query = dense_hetero_gcn_layers(adj_r, scope, s, self_w, xw0,
                                          model_def.conv_layers)[qi, query]
        outs.append(model_def.head(h_query)[..., 0])  # [Q, B]
    return torch.cat(outs, dim=1)


def _coo_outputs(model_def, problem: str, x, snd, rcv, evalid, ntype, etype, query,
                 n_valid, masks, chunk: int) -> torch.Tensor:
    """Generic formulation: the model's own forward with per-sample edge
    weights ``evalid * (m if edge else m[snd] * m[rcv])``; returns ``[Q, M]``
    (the query row's output, or the mean over valid nodes for graph
    problems).  The Q subgraphs run side by side as one block-diagonal
    graph (node ``v`` of query ``q`` is ``q * n + v``), which no operation
    mixes: a relation mixes rows only along its edges.  A typed model also
    gets the node and edge types ``ntype [Q, n]`` / ``etype [Q, e]``
    (None for an untyped one), flattened in the same order."""
    is_edge = "edge" in problem
    is_graph = "graph" in problem
    nq, n_masks, _ = masks.shape
    n = x.shape[1]
    off = (torch.arange(nq, device=x.device) * n)[:, None]
    xf = x.reshape(nq * n, x.shape[2])
    snd_f = (snd + off).reshape(-1)
    rcv_f = (rcv + off).reshape(-1)
    types = () if ntype is None else (ntype.reshape(-1), etype.reshape(-1))
    node_ok = (torch.arange(n, device=x.device)[None, :] < n_valid[:, None]).to(torch.float32)
    e = snd.shape[1]
    outs = []
    for c0 in range(0, n_masks, chunk):
        mf = masks[:, c0 : c0 + chunk].to(torch.float32)  # [Q, B, W]
        b = mf.shape[1]
        if is_edge:
            ew = evalid[:, None, :] * mf
        else:
            ms = torch.gather(mf, 2, snd[:, None, :].expand(nq, b, e))
            mr = torch.gather(mf, 2, rcv[:, None, :].expand(nq, b, e))
            ew = evalid[:, None, :] * (ms * mr)
        out = model_def(xf, snd_f, rcv_f, ew.transpose(0, 1).reshape(b, nq * e), *types)
        out = out[..., 0].reshape(b, nq, n).transpose(0, 1)  # [Q, B, n]
        if is_graph:
            outs.append(
                (out * node_ok[:, None, :]).sum(-1)
                / torch.clamp(node_ok.sum(-1), min=1.0)[:, None]
            )
        else:
            outs.append(torch.gather(out, 2, query[:, None, None].expand(nq, b, 1))[..., 0])
    return torch.cat(outs, dim=1)


def _phase(timer, name: str, device):
    """``timer.phase(name, sync=device)``, or nothing without a timer."""
    if timer is None:
        return contextlib.nullcontext()
    return timer.phase(name, sync=device)


@torch.no_grad()
def _run_stack(kind: str, model_def, problem: str, entry: dict, t: int,
               epochs: int, lr: float, l1: float, wd: float, timer=None) -> torch.Tensor:
    """Repeat ``t`` of every query of a launch plan: the best surrogate
    weights ``[Q, W]``, left on the device (nothing here waits for it)."""
    d = entry["dev"]
    width, n_masks, chunk = entry["width"], entry["n_masks"], entry["chunk"]
    keys = entry["keys"][t]
    dev = keys.device
    ne = d["ne"]
    col_valid = torch.arange(width, device=dev)[None, :] < ne[:, None]
    with _phase(timer, "mask_draw", dev):
        if entry["m_dev"] is None:
            masks = prng.bernoulli_tensor(
                prng.fold_in_tensor(keys, 0), 0.5, n_masks, width
            ) & col_valid[:, None, :]
        else:
            masks = _masks_in(entry["m_dev"][t], width)
    with _phase(timer, "forwards", dev):
        if kind == "dense":
            outputs = _dense_outputs(model_def, d["x"], d["adj"], d["q"], masks, chunk)
        elif kind == "hetero_dense":
            outputs = _hetero_dense_outputs(model_def, d["x"], d["adj_r"], d["scope"],
                                            d["q"], masks, chunk)
        else:
            outputs = _coo_outputs(model_def, problem, d["x"], d["snd"], d["rcv"], d["ev"],
                                   d.get("nt"), d.get("et"), d["q"], d["nv"], masks, chunk)
    with _phase(timer, "kernel_weights_and_training", dev):
        kern = _kernel_weights(masks, ne)
        return _train(masks, outputs, kern, prng.fold_in_tensor(keys, 1), ne,
                      col_valid, epochs, d["bs"], lr, l1, wd)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _check_inputs(model, graph: Graph, mesh) -> None:
    """Refuse ``mesh=`` (not ported), a typed model that is not a
    :class:`..models.gnn.HeteroGNN` (the JAX package's coo runner calls
    such a model without its type vectors, so its ``explain_many`` raises
    ``TypeError`` there; this adds no feature the JAX package lacks), and
    a hetero graph whose type ids name no type of the model (ids are
    positions in the model's ``node_type_names`` and ``relations``)."""
    if mesh is not None:
        raise NotImplementedError(
            "explain_many(mesh=...) needs parallel/, which is not ported yet"
        )
    mdef = model.model_def
    if model._typed and not isinstance(mdef, HeteroGNN):
        raise TypeError(
            f"explain_many does not serve {type(mdef).__name__}: of the typed models it "
            "serves only HeteroGNN, as the JAX package's explain_many, which calls any "
            "other model without node and edge types; explain it with Explainer.run"
        )
    if not isinstance(mdef, HeteroGNN):
        return
    hv = host_view(graph)
    for what, ids, names in (
        ("node type", hv.node_type[: graph.num_nodes], mdef.node_type_names),
        ("edge type", hv.edge_type[: graph.num_edges], mdef.relations),
    ):
        if ids.size and (ids.min() < 0 or ids.max() >= len(names)):
            raise ValueError(
                f"the graph's {what} ids reach {int(ids.max())}, but the model has "
                f"{len(names)} ({names}); ids are positions in the model's lists"
            )


def explain_many(
    model,
    graph: Graph,
    queries: Sequence[int],
    params_cfg: dict,
    names: Optional[Sequence[str]] = None,
    times: int = 1,
    chunk: int = 250,
    mesh=None,
    pathways=None,
    pathway_names=None,
    problem: str = "node_prediction",
    size_buckets: bool = True,
):
    """Explain Q queries, batched by padded-subgraph size bucket.

    Returns one sorted DataFrame per query (``(element_df, pathway_df)``
    pairs in community mode), with the JAX package's schema and order
    (``argsort(kind="stable")`` of the mean score).  The array form is
    :func:`_explain_many`, which needs no pandas.

    ``queries``: element indices: node indices for node/graph problems,
    edge indices for edge problems.  For graph problems pass one
    pseudo-query per wanted explanation (scores cover the whole graph).
    ``pathways`` / ``pathway_names``: communities as element-name lists
    (Configuration-Value mode).  ``size_buckets``: group queries by their
    subgraph's (node, edge) pow2 budget, one stack each; a query's draws
    then depend only on its own bucket (``False``: one stack padded to the
    largest).  A hetero model takes the graph's type ids as positions in
    its ``node_type_names`` and ``relations`` (``ValueError`` outside
    them).  ``mesh`` raises ``NotImplementedError``.
    """
    exs = _explain_many(
        model, graph, queries, params_cfg, names, times, chunk, mesh,
        pathways, pathway_names, problem, size_buckets,
    )
    return _assemble_dfs(exs)


def _explain_many(
    model,
    graph: Graph,
    queries: Sequence[int],
    params_cfg: dict,
    names: Optional[Sequence[str]] = None,
    times: int = 1,
    chunk: int = 250,
    mesh=None,
    pathways=None,
    pathway_names=None,
    problem: str = "node_prediction",
    size_buckets: bool = True,
    timer=None,
) -> List[Explanation]:
    """:func:`explain_many` as arrays: one :class:`.explainer.Explanation`
    per query, in input order (element scores in the order of the query's
    computational graph; community scores sorted descending).

    The device work of every stack (one for each size bucket) is enqueued
    before the host waits: the next stack's host work (extraction, community
    sampling, uploads from pinned memory) overlaps the last one's device
    work, and the weights come back in one copy at the end.  A size bucket
    is never split into sub-buckets, as the JAX package splits community
    buckets: here each stack costs the host thousands of launches, more
    than the sampling a split would overlap.  ``timer``: a
    :class:`..utils.profiling.PhaseTimer` that times the phases
    (``plan_build``, ``mask_draw``, ``forwards``,
    ``kernel_weights_and_training``, ``fetch_and_assembly``), synchronising
    the device at each phase's exit.
    """
    _check_inputs(model, graph, mesh)
    is_graph = "graph" in problem
    n_hops = model.model_def.num_hops + 1
    fp = (
        _content_fp(pathways) if pathways is not None else 0,
        _content_fp(names) if names is not None else 0,
    )
    if not size_buckets or is_graph or len(queries) <= 1:
        work = [(list(range(len(queries))), None, None)]
    else:
        subs = [_subgraph_cached(graph, s, n_hops) for s in _seed_nodes(graph, queries, problem)]
        buckets: dict = {}
        for i, s in enumerate(subs):
            key = (round_up_pow2(s.graph.num_nodes), max(round_up_pow2(s.graph.num_edges), 8))
            buckets.setdefault(key, []).append(i)
        if len(buckets) == 1:
            work = [(list(range(len(queries))), subs, None)]
        else:
            work = [(idxs, [subs[i] for i in idxs], np.asarray(idxs, np.int64))
                    for idxs in buckets.values()]

    launches = []
    for idxs, subs_w, orig_pos in work:
        ws, build = _explain_many_stacked(
            model, graph, [queries[i] for i in idxs], params_cfg, names, times,
            chunk, pathways, pathway_names, problem, subs=subs_w,
            orig_pos=orig_pos, fp=fp, timer=timer,
        )
        launches.append((idxs, ws, build))

    results: list = [None] * len(queries)
    with _phase(timer, "fetch_and_assembly", None):
        fetched = _fetch([ws for _, ws, _ in launches])
        for (idxs, _, build), f in zip(launches, fetched):
            for i, ex in zip(idxs, build(f)):
                results[i] = ex
    return results


def _fetch(stacks: List[List[torch.Tensor]]) -> List[List[np.ndarray]]:
    """Every stack's per-repeat weights to the host in ONE copy."""
    flat = [w for reps in stacks for w in reps]
    host = torch.cat([w.reshape(-1) for w in flat]).cpu().numpy()
    out, at = [], 0
    for reps in stacks:
        got = []
        for w in reps:
            got.append(host[at : at + w.numel()].reshape(w.shape))
            at += w.numel()
        out.append(got)
    return out


def _explain_many_stacked(
    model,
    graph: Graph,
    queries: Sequence[int],
    params_cfg: dict,
    names: Optional[Sequence[str]],
    times: int,
    chunk: int,
    pathways,
    pathway_names,
    problem: str,
    subs: Optional[list],
    orig_pos: Optional[np.ndarray],
    fp: tuple,
    timer=None,
):
    """Enqueue every repeat of one stack of queries.

    Returns ``(weights, build)``: the per-repeat ``[Q, W]`` weights, still
    on the device, and ``build(fetched)``, which turns their host copies
    into one :class:`.explainer.Explanation` per query.  Homogeneous
    ``GCNNodeModel`` node problems run the dense formulation, node problems
    of a hetero GCN the hetero_dense one, every other model and problem the
    coo one.  ``fp``: the content fingerprints of ``pathways`` and
    ``names``.
    """
    model_def = model.model_def
    node_problem = "edge" not in problem and "graph" not in problem
    if node_problem and isinstance(model_def, GCNNodeModel):
        kind = "dense"
    elif node_problem and is_hetero_gcn(model_def):
        kind = "hetero_dense"
    else:
        kind = "coo"
    n_hops = model_def.num_hops + 1

    epochs = int(params_cfg["epochs"])
    n_masks_cfg = int(params_cfg["interpret_samples"]) * epochs
    seed = int(params_cfg.get("seed", 0))
    lr = float(abs(params_cfg.get("lr", 0.01)))
    l1 = float(params_cfg.get("l1_lambda", 1e-4))
    wd = float(params_cfg.get("weight_decay", 1e-2))

    # ---- launch-plan cache ------------------------------------------------
    # everything but the device work is a pure function of (graph,
    # model_def, queries, config, communities): extraction, stacking,
    # uploads, keys and community masks.  A serving loop re-explaining a hot
    # query set pays only the device work and the fetch.
    plan_key = (
        id(graph), id(model_def), str(model.device), tuple(int(q) for q in queries),
        problem, times, seed, n_masks_cfg, epochs, lr, l1, wd, int(chunk),
        0 if pathways is None else id(pathways),
        0 if pathway_names is None else id(pathway_names),
        0 if names is None else id(names),
        None if orig_pos is None else tuple(int(p) for p in orig_pos),
    )
    entry = _plan_cache_get(plan_key, graph, model_def, pathways, names, fp)
    if entry is None:
        with _phase(timer, "plan_build", model.device):
            entry = _build_launch_plan(
                model, graph, queries, params_cfg, names, times, chunk,
                pathways, pathway_names, problem, subs, orig_pos, kind, n_hops, fp,
            )
        _plan_cache_put(plan_key, graph, model_def, pathways, names, fp, entry)

    weights_reps = [
        _run_stack(kind, model_def, problem, entry, t, epochs, lr, l1, wd, timer)
        for t in range(times)
    ]

    def build(fetched):
        return _assemble(fetched, entry)

    return weights_reps, build


_PLAN_CACHE: OrderedDict = OrderedDict()
#: plan entries hold device-resident operands (the Q stacked subgraphs plus
#: community mask stacks); 8 entries bound the device memory they keep
_PLAN_CACHE_MAX = 8


def _plan_cache_get(plan_key, graph, model_def, pathways, names, fp):
    """Launch-plan lookup: identity match on every object in the key plus
    the content fingerprint of the mutable list inputs."""
    hit = _PLAN_CACHE.get(plan_key)
    if (
        hit is not None
        and hit[0] is graph
        and hit[1] is model_def
        and (pathways is None or hit[2] is pathways)
        and (names is None or hit[3] is names)
        and hit[4] == fp
    ):
        return hit[5]
    return None


def _plan_cache_put(plan_key, graph, model_def, pathways, names, fp, entry):
    """Insert a launch plan; FIFO-bounded (see :data:`_PLAN_CACHE_MAX`)."""
    _PLAN_CACHE[plan_key] = (graph, model_def, pathways, names, fp, entry)
    while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.popitem(last=False)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; to a CUDA card through pinned memory
    and without waiting, so the host goes on while earlier work runs."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _build_launch_plan(
    model, graph, queries, params_cfg, names, times, chunk,
    pathways, pathway_names, problem, subs, orig_pos, kind, n_hops, fp,
):
    """The device-ready launch plan of one stack of queries: every
    pure-function-of-inputs stage of :func:`_explain_many_stacked`."""
    is_edge = "edge" in problem
    is_graph = "graph" in problem
    # only the coo route reads type ids (the hetero_dense one has them in
    # its per-relation adjacencies and scopes)
    typed = model._typed and kind == "coo"
    dev = model.device

    if subs is None and not is_graph:
        subs = [_subgraph_cached(graph, s, n_hops) for s in _seed_nodes(graph, queries, problem)]
    st = _Stack(graph, _seed_nodes(graph, queries, problem), n_hops,
                need_edges=kind == "coo", typed=typed, full_graph=is_graph, subs=subs,
                rel_model=model.model_def if kind == "hetero_dense" else None)
    qn = st.qn
    if orig_pos is None:
        orig_pos = np.arange(qn, dtype=np.int64)

    n_masks = int(params_cfg["interpret_samples"]) * int(params_cfg["epochs"])
    epochs = int(params_cfg["epochs"])
    seed = int(params_cfg.get("seed", 0))

    n_elem_arr = st.evalid_count if is_edge else st.nvalid
    width = st.e_pad if is_edge else st.n_pad
    all_names_arr = (
        np.array(names, dtype=str)
        if names is not None
        else np.arange(graph.e_pad if is_edge else graph.n_pad).astype(str)
    )
    # every (repeat, query) key: host-built, cached across calls; the rows
    # drive both the host community sampler and the device draws
    kd_all = _folded_keys_cached(seed, times, tuple(int(p) for p in orig_pos))

    mask_stacks = None  # [T][Q] host masks in community mode
    bs_real = np.full((qn,), n_masks // epochs, np.int64)
    sub_pw_per_q = None
    if pathways is not None:
        pw_names_list = list(pathway_names) if pathway_names is not None else list(range(len(pathways)))
        pw_global = _pathways_global_ids_cached(
            pathways, all_names_arr, names if names is not None else _NO_NAMES
        )
        cap = graph.e_pad if is_edge else graph.n_pad
        sub_pw_per_q = []
        bs_max = 0
        # the sampler's row budget (MaskSampler abs()'s the config values)
        total_cfg = abs(int(params_cfg["interpret_samples"])) * abs(int(params_cfg["epochs"]))
        raw: List[List[np.ndarray]] = [[None] * qn for _ in range(times)]
        for qi in range(qn):
            ne = int(n_elem_arr[qi])
            parents = st.parent_edges[qi] if is_edge else st.parent_nodes[qi]
            centry = _community_query_cached(
                graph, pathways, names if names is not None else _NO_NAMES,
                queries[qi], parents, ne, width, total_cfg,
                pw_global, pw_names_list, cap, content_fp=fp,
            )
            sub_pw_per_q.append((centry["sub_pw_names"], centry["seg"]))
            sampler = MaskSampler(ne, width, params_cfg, centry["sub_inds"])
            sampler._layout = centry["layout"]
            for t in range(times):
                mq, _tags, bs_q = sampler.sample(kd_all[t, qi])
                raw[t][qi] = np.asarray(mq)
                bs_real[qi] = bs_q
                bs_max = max(bs_max, bs_q)
        # per-query [epochs, bs_q] layout padded on the batch axis: batch i
        # holds exactly the rows Explainer's batch i holds, plus inert pads
        n_masks = bs_max * epochs
        mask_stacks = []
        for t in range(times):
            per_q = []
            for qi in range(qn):
                bs_q = int(bs_real[qi])
                mq = raw[t][qi][: bs_q * epochs].reshape(epochs, bs_q, width)
                pad = np.zeros((epochs, bs_max - bs_q, width), bool)
                per_q.append(np.concatenate([mq, pad], axis=1).reshape(n_masks, width))
            mask_stacks.append(per_q)

    chunk = min(chunk, n_masks)
    while n_masks % chunk:
        chunk -= 1

    base = {"x": st.xs, "q": st.qidx, "nv": st.nvalid, "ne": n_elem_arr, "bs": bs_real}
    if kind == "dense":
        base["adj"] = st.adjs
    elif kind == "hetero_dense":
        base.update(adj_r=st.adjs_r, scope=st.scopes)
    else:
        base.update(snd=st.snds, rcv=st.rcvs, ev=st.evalid)
        if typed:
            base.update(nt=st.ntype, et=st.etype)
    return {
        "qn": qn,
        "parents": st.parent_edges if is_edge else st.parent_nodes,
        "n_elem_arr": n_elem_arr,
        "all_names_arr": all_names_arr,
        "sub_pw_per_q": sub_pw_per_q,
        "n_masks": n_masks,
        "chunk": chunk,
        "width": width,
        "dev": {k: _upload(v, dev) for k, v in base.items()},
        "keys": [_upload(kd_all[t].astype(np.int64), dev) for t in range(times)],
        # packbits: 8 mask bits per shipped byte (see _unpack_mask_bits)
        "m_dev": None if mask_stacks is None else [
            _upload(np.packbits(np.stack(mask_stacks[t]), axis=-1), dev)
            for t in range(times)
        ],
    }


def _assemble(fetched: List[np.ndarray], entry: dict) -> List[Explanation]:
    """Per-repeat host weights ``[T][Q, W]`` -> one Explanation per query
    (mean and population std over the repeats)."""
    qn = entry["qn"]
    stack = np.stack([np.asarray(w)[:qn] for w in fetched])  # [T, Q, W]
    mean = stack.mean(0)
    std = stack.std(0)
    out = []
    for qi in range(qn):
        ne = int(entry["n_elem_arr"][qi])
        sub_names = entry["all_names_arr"][entry["parents"][qi]]
        pw_names = pw_scores = None
        if entry["sub_pw_per_q"] is not None:
            sub_pw_names, table = entry["sub_pw_per_q"][qi]
            pw_names, pw_scores = segment_means(mean[qi, :ne], sub_pw_names, table)
        out.append(Explanation(
            names=sub_names.tolist(), mean=mean[qi, :ne], std=std[qi, :ne],
            pathway_names=pw_names, pathway_scores=pw_scores,
        ))
    return out


def _assemble_dfs(explanations: List[Explanation]):
    """Explanations -> the JAX package's frames: per query a DataFrame of
    ``config_value_mean`` / ``config_value_std`` indexed by ``name``, sorted
    by ``argsort(-mean, kind="stable")``; in community mode paired with the
    ``score`` frame of the communities."""
    import pandas as pd

    cv_cols = pd.Index(["config_value_mean", "config_value_std"])
    pw_cols = pd.Index(["score"])
    dfs = []
    for ex in explanations:
        order = np.argsort(-ex.mean, kind="stable")
        df = pd.DataFrame(
            np.column_stack([ex.mean[order], ex.std[order]]),
            columns=cv_cols,
            index=pd.Index(np.asarray(ex.names)[order], name="name"),
            copy=False,
        )
        if ex.pathway_names is None:
            dfs.append(df)
            continue
        pw_df = pd.DataFrame(
            ex.pathway_scores[:, None], columns=pw_cols,
            index=pd.Index(ex.pathway_names, name="name"), copy=False,
        )
        dfs.append((df, pw_df))
    return dfs
