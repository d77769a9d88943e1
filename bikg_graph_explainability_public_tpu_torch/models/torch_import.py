"""PyG ``.pth.tar`` checkpoints as the port's state dicts.

The reference loads user GNN checkpoints saved as dicts with a ``"model"``
state-dict key (``tests/test_utils.py:392-394`` of the reference,
``README.md:155-156``).  The importers here map such a state dict to the
parameter names of the port's models, which are the JAX package's tree
paths: PyG's ``conv.{2i}`` (the reference models interleave ReLUs in their
ModuleList) becomes ``conv.{i}``, ``fc.{2j}`` becomes ``fc.{j}``, a
homogeneous GAT's one shared ``lin_src`` fills both ``lin_src`` and
``lin_dst``, and GIN's ``nn.{2j}`` becomes ``nn.{j}``.  The result loads
with ``load_state_dict`` (or :class:`.adapter.Model`'s ``params``).

Hetero stacks of PyG ``HeteroConv`` (``conv.{2i}.convs.<src__rel__dst>.``)
map to :class:`.gnn.HeteroGNN`'s ``conv.{i}.<src__rel__dst>.``, with
per-relation GCN, SAGE or GAT convs (a hetero GAT relation without
``lin_dst`` takes a copy of ``lin_src``).  PyG's ``RGCNConv`` layout
(``weight`` ``[R, in, out]`` or bases with ``comp``, ``root``, ``bias``;
not transposed) maps to :class:`.gnn.RGCNNodeModel` under the same names.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]


def load_state_dict(path: str) -> StateDict:
    """Read a ``.pth.tar`` checkpoint's ``model`` state dict (CPU tensors)."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = ck["model"] if isinstance(ck, dict) and "model" in ck else ck
    return {k: v.detach().cpu() for k, v in sd.items()}


def _t(a) -> torch.Tensor:
    """A tensor or numpy array as a float32 CPU tensor of its own."""
    return torch.as_tensor(a).detach().to("cpu", torch.float32).clone()


def _indices(sd: Mapping, prefix: str) -> List[int]:
    """Sorted module indices under ``prefix`` that own parameters (any
    stride: the reference models interleave activations, so 0, 2, 4, ...)."""
    out = set()
    for k in sd:
        if k.startswith(prefix):
            first = k[len(prefix):].split(".")[0]
            if first.isdigit():
                out.add(int(first))
    return sorted(out)


def _fc(sd: Mapping, indices) -> StateDict:
    """The FC head ``fc.{idx}`` as ``fc.{j}``."""
    out = {}
    for j, idx in enumerate(indices):
        out[f"fc.{j}.weight"] = _t(sd[f"fc.{idx}.weight"])
        out[f"fc.{j}.bias"] = _t(sd[f"fc.{idx}.bias"])
    return out


def _opt(sd: Mapping, out: StateDict, key: str, src: str) -> None:
    if src in sd:
        out[key] = _t(sd[src])


def _layer_params(sd: Mapping, pre: str, family: str) -> StateDict:
    """One conv layer's parameters under the port's names (relative keys)."""
    p: StateDict = {}
    if family == "gcn":
        p["weight"] = _t(sd[pre + "lin.weight"])
        _opt(sd, p, "bias", pre + "bias")
    elif family == "gat":
        w = sd[pre + ("lin_src.weight" if pre + "lin_src.weight" in sd else "lin.weight")]
        p["lin_src.weight"] = _t(w)
        p["lin_dst.weight"] = _t(sd.get(pre + "lin_dst.weight", w))
        p["att_src"] = _t(sd[pre + "att_src"])
        p["att_dst"] = _t(sd[pre + "att_dst"])
        _opt(sd, p, "bias", pre + "bias")
    elif family == "gatv2":
        p["lin_l.weight"] = _t(sd[pre + "lin_l.weight"])
        _opt(sd, p, "lin_l.bias", pre + "lin_l.bias")
        p["lin_r.weight"] = _t(sd.get(pre + "lin_r.weight", sd[pre + "lin_l.weight"]))
        _opt(sd, p, "lin_r.bias", pre + ("lin_r.bias" if pre + "lin_r.bias" in sd else "lin_l.bias"))
        p["att"] = _t(sd[pre + "att"])
        _opt(sd, p, "bias", pre + "bias")
    elif family == "sage":
        p["lin_l.weight"] = _t(sd[pre + "lin_l.weight"])
        _opt(sd, p, "lin_l.bias", pre + "lin_l.bias")
        p["lin_r.weight"] = _t(sd[pre + "lin_r.weight"])
    elif family == "graphconv":
        p["lin_rel.weight"] = _t(sd[pre + "lin_rel.weight"])
        _opt(sd, p, "lin_rel.bias", pre + "lin_rel.bias")
        p["lin_root.weight"] = _t(sd[pre + "lin_root.weight"])
    elif family == "gin":
        for j, idx in enumerate(_indices(sd, pre + "nn.")):
            p[f"nn.{j}.weight"] = _t(sd[f"{pre}nn.{idx}.weight"])
            p[f"nn.{j}.bias"] = _t(sd[f"{pre}nn.{idx}.bias"])
        # PyG keeps eps as a [1] buffer; the port's is a scalar
        p["eps"] = _t(sd.get(pre + "eps", torch.zeros(()))).reshape(())
    elif family == "rgcn":
        p["weight"] = _t(sd[pre + "weight"])
        _opt(sd, p, "comp", pre + "comp")
        p["root"] = _t(sd[pre + "root"])
        _opt(sd, p, "bias", pre + "bias")
    else:
        raise ValueError(f"unsupported homogeneous family {family!r}")
    return p


#: per family: its display name and the keys that mark one of its layers
_FAMILIES = {
    "gcn": ("GCN", ("lin.weight",)),
    "gat": ("GAT", ("lin_src.weight", "lin.weight")),
    "gatv2": ("GATv2", ("lin_l.weight",)),
    "sage": ("SAGE", ("lin_l.weight",)),
    "graphconv": ("GraphConv", ("lin_rel.weight",)),
    "gin": ("GIN", ("nn.0.weight",)),
    "rgcn": ("RGCN", ("root",)),
}


def _stack_params(sd: Mapping, family: str, fc: StateDict) -> StateDict:
    """Layers ``conv.0, conv.2, ...`` of one family, while they last, as
    ``conv.{i}.*``, plus the head."""
    name, marks = _FAMILIES[family]
    out: StateDict = {}
    i = 0
    while any(f"conv.{2 * i}.{m}" in sd for m in marks):
        for k, v in _layer_params(sd, f"conv.{2 * i}.", family).items():
            out[f"conv.{i}.{k}"] = v
        i += 1
    if not out or not fc:
        raise ValueError(f"state dict does not look like a {name} conv+fc stack")
    out.update(fc)
    return out


def gcn_node_model_params(sd: Mapping) -> StateDict:
    """A ``GCN_homo``-layout state dict (``conv.{2i}.lin.weight``,
    ``conv.{2i}.bias``, ``fc.{2j}.*``) as :class:`.gnn.GCNNodeModel`'s."""
    fc_idx = []
    while f"fc.{2 * len(fc_idx)}.weight" in sd:
        fc_idx.append(2 * len(fc_idx))
    return _stack_params(sd, "gcn", _fc(sd, fc_idx))


def gat_node_model_params(sd: Mapping) -> StateDict:
    """PyG ``GATConv`` layout (``conv.{2i}.lin_src.weight`` [H*C, in], shared
    with ``lin_dst`` for non-bipartite input, ``att_src`` / ``att_dst``
    [1, H, C], ``bias``) as :func:`.gnn.gat_node_model`'s."""
    return _stack_params(sd, "gat", _fc(sd, _indices(sd, "fc.")))


def gatv2_node_model_params(sd: Mapping) -> StateDict:
    """PyG ``GATv2Conv`` layout (``lin_l``, ``lin_r`` equal to ``lin_l`` when
    absent, ``att``, ``bias``) as :func:`.gnn.gatv2_node_model`'s."""
    return _stack_params(sd, "gatv2", _fc(sd, _indices(sd, "fc.")))


def sage_node_model_params(sd: Mapping) -> StateDict:
    """PyG ``SAGEConv`` layout (``lin_l.{weight,bias}``, ``lin_r.weight``)
    as :func:`.gnn.sage_node_model`'s."""
    return _stack_params(sd, "sage", _fc(sd, _indices(sd, "fc.")))


def graph_conv_node_model_params(sd: Mapping) -> StateDict:
    """PyG ``GraphConv`` layout (``lin_rel.{weight,bias}``,
    ``lin_root.weight``) as :func:`.gnn.graph_conv_node_model`'s."""
    return _stack_params(sd, "graphconv", _fc(sd, _indices(sd, "fc.")))


def gin_node_model_params(sd: Mapping) -> StateDict:
    """PyG ``GINConv`` layout (``nn.{2j}.{weight,bias}``, optional ``eps``)
    as :func:`.gnn.gin_node_model`'s."""
    return _stack_params(sd, "gin", _fc(sd, _indices(sd, "fc.")))


def rgcn_node_model_params(sd: Mapping) -> StateDict:
    """PyG ``RGCNConv`` layout (``conv.{2i}.weight`` ``[R, in, out]`` or
    ``[num_bases, in, out]`` with ``comp [R, num_bases]``, ``root [in,
    out]``, ``bias``; not transposed) as :class:`.gnn.RGCNNodeModel`'s."""
    return _stack_params(sd, "rgcn", _fc(sd, _indices(sd, "fc.")))


def hetero_relations_from_state_dict(sd: Mapping) -> List[Tuple[str, ...]]:
    """The relation tuples named by a hetero checkpoint's keys
    (``conv.0.convs.<src__rel__dst>.``, PyG ``HeteroConv``'s module-dict
    convention), sorted by their joined names."""
    prefix = "conv.0.convs."
    rels = sorted({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})
    return [tuple(r.split("__")) for r in rels]


#: the conv families a hetero relation may have
_HETERO_FAMILIES = ("gcn", "sage", "gat")


def _hetero_layers(sd: Mapping) -> List[Tuple[str, List[Tuple[str, str]]]]:
    """(key prefix, ``(relation key src__rel__dst, family)`` sorted by key)
    of each hetero layer ``conv.{i}.convs.``, in index order.  A layer may
    mix GCN, SAGE and GAT relations; any other family raises
    ``ValueError``."""
    layers = []
    for ci in _indices(sd, "conv."):
        prefix = f"conv.{ci}.convs."
        rels = sorted({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})
        if not rels:
            raise ValueError(f"hetero layer conv.{ci} has no relations")
        fams = [(rel, _layer_family(sd, f"{prefix}{rel}.")) for rel in rels]
        for rel, fam in fams:
            if fam not in _HETERO_FAMILIES:
                raise ValueError(
                    f"hetero relation {rel!r} layer family {fam!r} is "
                    "not supported (GCN/SAGE/GAT per-relation convs are)"
                )
        layers.append((prefix, fams))
    return layers


def _hetero_params(sd: Mapping, family: Optional[str] = None) -> StateDict:
    """A HeteroConv stack's parameters as :class:`.gnn.HeteroGNN`'s
    (``conv.{i}.<src__rel__dst>.*``, then the head).  With ``family``,
    every relation must be of it."""
    name = _FAMILIES[family][0] if family else "GCN/SAGE/GAT"
    out: StateDict = {}
    for i, (prefix, fams) in enumerate(_hetero_layers(sd)):
        for rel, fam in fams:
            if family is not None and fam != family:
                raise ValueError(f"hetero relation {rel!r} of conv.{i} is {fam!r}, not {family!r}")
            for k, v in _layer_params(sd, f"{prefix}{rel}.", fam).items():
                out[f"conv.{i}.{rel}.{k}"] = v
    fc = _fc(sd, _indices(sd, "fc."))
    if not out or not fc:
        raise ValueError(f"state dict does not look like a HeteroConv {name} stack")
    out.update(fc)
    return out


def hetero_gcn_params(sd: Mapping) -> StateDict:
    """A HeteroConv-of-GCNConv state dict (``conv.{2i}.convs.<src__rel__dst>.
    lin.weight`` / ``.bias``, ``fc.{2j}.*``) as :class:`.gnn.HeteroGNN`'s
    (``conv.{i}.<src__rel__dst>.weight``)."""
    return _hetero_params(sd, "gcn")


def hetero_sage_params(sd: Mapping) -> StateDict:
    """A HeteroConv-of-SAGEConv state dict (``conv.{2i}.convs.<src__rel__dst>.
    lin_l.{weight,bias}``, ``.lin_r.weight``, ``fc.{2j}.*``) as
    :class:`.gnn.HeteroGNN`'s."""
    return _hetero_params(sd, "sage")


def hetero_gat_params(sd: Mapping) -> StateDict:
    """A HeteroConv-of-GATConv state dict (the reference hetero *test*
    architecture: ``conv.{2i}.convs.<src__rel__dst>.{lin_src.weight,
    lin_dst.weight, att_src, att_dst, bias}``, ``fc.{2j}.*``) as
    :class:`.gnn.HeteroGNN`'s; a missing ``lin_dst`` is a copy of
    ``lin_src``."""
    return _hetero_params(sd, "gat")


def gat_config_from_state_dict(sd: Mapping) -> List[dict]:
    """Per-layer ``{"heads", "channels", "concat"}`` of a GAT/GATv2 stack:
    heads and channels from ``att_src`` / ``att`` [1, H, C], concat from
    the bias length ([H*C] concat, [C] mean; concat without a bias)."""
    layers = []
    i = 0
    while True:
        pre = f"conv.{2 * i}."
        att_key = next((k for k in (pre + "att_src", pre + "att") if k in sd), None)
        if att_key is None:
            break
        _, h, c = sd[att_key].shape
        bias = sd.get(pre + "bias")
        concat = True if bias is None else (bias.shape[0] == h * c or h == 1)
        layers.append({"heads": int(h), "channels": int(c), "concat": concat})
        i += 1
    if not layers:
        raise ValueError("state dict has no GAT-style attention parameters")
    return layers


def _layer_family(sd: Mapping, pre: str) -> str:
    """One conv layer's PyG family, from its parameter keys."""
    if pre + "lin.weight" in sd:
        return "gcn"
    if pre + "att" in sd and pre + "lin_l.weight" in sd:
        return "gatv2"
    if pre + "att_src" in sd or pre + "lin_src.weight" in sd:
        return "gat"
    if pre + "lin_rel.weight" in sd:
        return "graphconv"
    if pre + "nn.0.weight" in sd:
        return "gin"
    if pre + "weight" in sd and pre + "root" in sd:
        return "rgcn"
    if pre + "lin_l.weight" in sd and pre + "lin_r.weight" in sd:
        return "sage"
    known = sorted(k for k in sd if k.startswith(pre))[:6]
    raise ValueError(
        f"unrecognised conv layer layout at {pre!r}: keys {known} match no "
        "supported PyG family (GCN/GAT/GATv2/SAGE/GraphConv/GIN/RGCN)"
    )


def _homo_layer(sd: Mapping, pre: str, family: str, prev: int) -> Tuple[nn.Module, StateDict, int]:
    """(conv module, its parameters, output width) of one layer."""
    from .layers import GATConv, GATv2Conv, GCNConv, GINConv, GraphConv, SAGEConv

    p = _layer_params(sd, pre, family)
    if family in ("gat", "gatv2"):
        _, h, c = p["att_src" if family == "gat" else "att"].shape
        concat = "bias" not in p or h == 1 or p["bias"].shape[0] == h * c
        if family == "gat":
            conv = GATConv((prev, prev), c, heads=h, concat=concat)
        else:
            share = pre + "lin_r.weight" not in sd
            conv = GATv2Conv((prev, prev), c, heads=h, concat=concat, share_weights=share)
        return conv, p, h * c if concat else c
    if family == "gin":
        widths = [int(p[f"nn.{j}.weight"].shape[0]) for j in range(len(p) // 2)]
        return GINConv(prev, widths[-1], mlp_channels=tuple(widths[:-1])), p, widths[-1]
    cls, key = {
        "gcn": (GCNConv, "weight"), "sage": (SAGEConv, "lin_l.weight"),
        "graphconv": (GraphConv, "lin_rel.weight"),
    }[family]
    width = int(p[key].shape[0])
    return cls(prev, width), p, width


def _hetero_conv(family: str, p: StateDict, prev: Optional[int]) -> Tuple[nn.Module, int]:
    """(conv module, output width) of one hetero relation from its
    parameters ``p``; ``prev`` the layer's input width (None: read it from
    the weight).  A GAT relation concatenates its heads, as the JAX
    package's importer builds it."""
    from .layers import GATConv, GCNConv, SAGEConv

    if family == "gat":
        _, h, c = p["att_src"].shape
        prev = int(p["lin_src.weight"].shape[1]) if prev is None else prev
        conv = GATConv((prev, prev), int(c), heads=int(h), add_self_loops=False, bias="bias" in p)
        return conv, int(h * c)
    cls, key, bias_key = {
        "gcn": (GCNConv, "weight", "bias"), "sage": (SAGEConv, "lin_l.weight", "lin_l.bias"),
    }[family]
    out_f, in_f = (int(d) for d in p[key].shape)
    return cls(in_f if prev is None else prev, out_f, bias=bias_key in p), out_f


def import_any(sd: Mapping) -> Tuple[nn.Module, StateDict]:
    """Sniff a PyG conv+fc checkpoint's architecture: returns a ready
    ``(model_def, params)`` pair.

    Per-layer families come from the key patterns (``lin.weight``,
    ``lin_src`` / ``att_src``, ``lin_l`` + ``att``, ``lin_l`` + ``lin_r``,
    ``lin_rel``, ``nn.{j}``, ``weight`` + ``root``).  GCN-only stacks build
    :class:`.gnn.GCNNodeModel` (the fused engine's model); mixed stacks
    build :class:`.gnn.ConvStackNodeModel`; RGCN stacks build
    :class:`.gnn.RGCNNodeModel` (``num_relations`` from ``comp`` where
    there is one; mixed with another family, ``ValueError``);
    ``.convs.<src__rel__dst>.`` keys of GCN, SAGE or GAT convs build
    :class:`.gnn.HeteroGNN`, whose node types are the relations' type
    names sorted and whose relations are each layer's keys sorted (as the
    JAX package builds them; the port's
    :class:`..explain.explainer.Explainer` matches a graph's types to them
    by name).  Unknown layouts raise ``ValueError``.
    """
    from .gnn import ConvStackNodeModel, GCNNodeModel, HeteroGNN, RGCNNodeModel

    fc = _fc(sd, _indices(sd, "fc."))
    if not fc:
        raise ValueError(
            "state dict has no fc.{2j}.weight head — not a supported conv+fc checkpoint layout"
        )
    n_fc = len(fc) // 2
    fc_channels = tuple(int(fc[f"fc.{j}.weight"].shape[1]) for j in range(n_fc))
    out_features = int(fc[f"fc.{n_fc - 1}.weight"].shape[0])
    conv_idx = _indices(sd, "conv.")
    if not conv_idx:
        raise ValueError("state dict has no conv.{i}.* parameters")
    if any(k.startswith(f"conv.{conv_idx[0]}.convs.") for k in sd):
        relations = hetero_relations_from_state_dict(sd)
        ntypes = sorted({r[0] for r in relations} | {r[-1] for r in relations})
        params = _hetero_params(sd)
        layers, prev = [], None
        for i, (_prefix, fams) in enumerate(_hetero_layers(sd)):
            layer = {}
            for rel, fam in fams:
                pre = f"conv.{i}.{rel}."
                p = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
                layer[tuple(rel.split("__"))], width = _hetero_conv(fam, p, prev)
            layers.append(layer)
            prev = width
        return HeteroGNN(ntypes, layers, fc_channels, out_features), params
    families = [_layer_family(sd, f"conv.{ci}.") for ci in conv_idx]
    if "rgcn" in families:
        if set(families) != {"rgcn"}:
            raise ValueError(f"RGCN layers cannot mix with other conv families (found {families})")
        params = rgcn_node_model_params(sd)
        w0 = params["conv.0.weight"]
        comp = params.get("conv.0.comp")
        n_conv = sum(k.endswith(".root") for k in params)
        mdef = RGCNNodeModel(
            int(w0.shape[1]), int(w0.shape[0] if comp is None else comp.shape[0]),
            conv_channels=tuple(int(params[f"conv.{i}.weight"].shape[2]) for i in range(n_conv)),
            num_bases=None if comp is None else int(comp.shape[1]),
            fc_channels=fc_channels, out_features=out_features,
        )
        for i, conv in enumerate(mdef.conv):
            if f"conv.{i}.bias" not in params:
                conv.bias = None
        return mdef, params
    if set(families) == {"gcn"}:
        params = gcn_node_model_params(sd)
        channels = tuple(v.shape[0] for k, v in params.items() if k.startswith("conv.") and k.endswith("weight"))
        in_features = int(params["conv.0.weight"].shape[1])
        mdef = GCNNodeModel(in_features, conv_channels=channels, fc_channels=fc_channels,
                            out_features=out_features)
        return mdef, params
    first = f"conv.{conv_idx[0]}."
    prev = next(
        int(sd[first + k].shape[1])
        for k in ("lin.weight", "lin_src.weight", "lin_l.weight", "lin_rel.weight", "nn.0.weight")
        if first + k in sd
    )
    convs, params = [], {}
    for i, (ci, fam) in enumerate(zip(conv_idx, families)):
        conv, p, prev = _homo_layer(sd, f"conv.{ci}.", fam, prev)
        convs.append(conv)
        params.update({f"conv.{i}.{k}": v for k, v in p.items()})
    params.update(fc)
    return ConvStackNodeModel(convs, fc_channels, out_features), params
