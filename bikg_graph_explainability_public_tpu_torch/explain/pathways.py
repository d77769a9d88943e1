"""Community ("pathway") layer.

Reference: ``src/pathway_explanations/pathways.py`` (L3).  Ragged community
structure is host-side metadata, handled with numpy.  pandas is imported
only where a DataFrame is built (:meth:`Pathways.aggregate`), so the rest of
the port runs where pandas is not installed.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np


class Pathways:
    """Graph communities and their transformations.

    ``communities`` is a list of lists of node names (str) or indices
    (int), or for a heterogeneous graph a dict of such lists keyed by node
    type (edge type for edge problems), flattened by :meth:`hetero2homo`;
    ``community_names`` defaults to indices for a list, and for a dict is a
    dict of name lists with the same keys.  A dict of communities is
    copied: shifting integer communities changes the copy, never the
    caller's lists.
    """

    def __init__(self, communities, community_names=None):
        if isinstance(communities, dict):
            communities = {k: [list(c) for c in v] for k, v in communities.items()}
        self.communities = communities
        self.community_names = community_names
        if self.community_names is None and not isinstance(communities, dict):
            self.community_names = np.arange(len(communities)).tolist()

    def shift_hetero_pathways(self, pointers: Mapping) -> None:
        """Shift integer communities by the start pointer of their type's
        block, looked up by type name (reference ``pathways.py:138``, which
        pairs the dict's keys with the pointers by position)."""
        for key, comms in self.communities.items():
            self.communities[key] = [
                (np.asarray(c) + pointers[key]).tolist() for c in comms
            ]

    def hetero2homo(
        self,
        problem: str,
        node_pointers: Optional[Mapping] = None,
        edge_pointers: Optional[Mapping] = None,
    ) -> Tuple[list, list, Optional[np.ndarray]]:
        """Flatten a dict of per-type community lists into one list, shifting
        integer communities by the homogenisation pointers (``{type name:
        pointer}``, node types for node and graph problems, relations for
        edge problems), with each community's type position in the dict.
        A list passes through with no types."""
        if not isinstance(self.communities, dict):
            return self.communities, self.community_names, None
        if not isinstance(self.community_names, dict):
            raise ValueError("dict communities need a dict of community names with the same keys")
        first = next(iter(self.communities.values()))[0][0]
        if isinstance(first, (int, float, np.integer, np.floating)):
            if "node" in problem:
                self.shift_hetero_pathways(node_pointers)
            elif "edge" in problem:
                self.shift_hetero_pathways(edge_pointers)
        types, flat, names = [], [], []
        for i, (key, comms) in enumerate(self.communities.items()):
            types.append(np.full((len(comms),), i, np.int32))
            flat.extend(comms)
            names.extend(self.community_names[key])
        return flat, names, np.concatenate(types)

    def comp_graph(self, names: Sequence) -> Tuple[list, list]:
        """Keep only the part of each community that intersects the
        computational graph; drop empty communities.

        ``np.intersect1d`` string semantics preserved: the surviving elements
        of each community come back sorted lexicographically as strings."""
        names_array = np.array(names, dtype=str)
        sub_pathway, sub_names = [], []
        for community, cname in zip(self.communities, self.community_names):
            common = np.intersect1d(np.array(community, dtype=str), names_array)
            if len(common) > 0:
                sub_pathway.append(common.tolist())
                sub_names.append(cname)
        return sub_pathway, sub_names

    def names2inds(self, names: Sequence) -> List[List[int]]:
        """Element-name lists -> index lists against the subgraph's names
        (reference pathways.py:104)."""
        if len(self.communities) and isinstance(self.communities[0][0], (int, np.integer)):
            return self.communities
        inds = []
        names_array = np.array(names, dtype=str)
        for community in self.communities:
            community_array = np.array(community, dtype=str)
            _, ind, _ = np.intersect1d(names_array, community_array, return_indices=True)
            inds.append(ind.tolist())
        return inds

    def aggregate_arrays(
        self, config_val, community_inds: Sequence[Sequence[int]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Mean config value per community as (names, scores), sorted by
        score descending, communities without elements dropped."""
        return segment_means(config_val, self.community_names, segment_table(community_inds))

    def aggregate(self, config_val, community_inds: Sequence[Sequence[int]]):
        """:meth:`aggregate_arrays` as a DataFrame."""
        return pathway_dataframe(*self.aggregate_arrays(config_val, community_inds))


def pathway_dataframe(names, scores):
    """Community scores as a pandas DataFrame (column ``score``, index
    ``name``), in the order given."""
    import pandas as pd

    return pd.DataFrame({"score": scores}, index=pd.Index(names, name="name"))


def segment_means(config_val, community_names, table) -> Tuple[np.ndarray, np.ndarray]:
    """Mean config value per community of a :func:`segment_table`, as
    (names, scores) sorted by score descending; communities without
    elements drop."""
    elements, seg, lengths = table
    vals = np.asarray(config_val, np.float64)
    sums = np.bincount(seg, weights=vals[elements], minlength=len(lengths))
    with np.errstate(invalid="ignore"):
        scores = np.where(lengths > 0, sums / np.maximum(lengths, 1), np.nan)
    names = np.asarray(list(community_names), object)
    keep = ~np.isnan(scores)
    sc, nm = scores[keep], names[keep]
    o = np.argsort(-sc, kind="stable")
    return nm[o], sc[o]


def segment_table(
    community_inds: Sequence[Sequence[int]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten ragged communities into (elements, segment_ids, lengths)."""
    elements = np.concatenate(
        [np.asarray(c, np.int32) for c in community_inds]
    ) if community_inds else np.zeros((0,), np.int32)
    seg = np.concatenate(
        [np.full((len(c),), i, np.int32) for i, c in enumerate(community_inds)]
    ) if community_inds else np.zeros((0,), np.int32)
    lengths = np.array([len(c) for c in community_inds], np.int32)
    return elements, seg, lengths
