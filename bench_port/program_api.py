"""The program's private functions the benchmark reaches, with the
signatures it relies on, pinned in one place.

The traced ``explain_many`` window calls ``batch._explain_many(...,
timer=)`` and ``batch._assemble_dfs`` (``explain_many`` takes no timer),
and the fault tests break ``_train``, ``_kernel_weights``, ``_assemble``,
``wlm.train_surrogate``, ``wlm.shap_kernel`` and
``explainer.weight_stacking`` by position or keyword.  A change to any of
them fails here, loudly, instead of moving the traced run onto another
path or a fault onto nothing.
"""

from __future__ import annotations

import importlib
import inspect

PACKAGE = "bikg_graph_explainability_public_tpu_torch"

# (module, function) -> the parameter names, in order
PINNED = {
    ("explain.batch", "explain_many"): (
        "model", "graph", "queries", "params_cfg", "names", "times", "chunk", "mesh",
        "pathways", "pathway_names", "problem", "size_buckets"),
    ("explain.batch", "_explain_many"): (
        "model", "graph", "queries", "params_cfg", "names", "times", "chunk", "mesh",
        "pathways", "pathway_names", "problem", "size_buckets", "timer"),
    ("explain.batch", "_assemble_dfs"): ("explanations",),
    ("explain.batch", "_assemble"): ("fetched", "entry"),
    ("explain.batch", "_kernel_weights"): ("masks", "n_elements"),
    ("explain.batch", "_train"): (
        "masks", "outputs", "kern", "keys", "n_elements", "col_valid", "epochs", "bs_real",
        "lr", "l1", "wd"),
    ("explain.wlm", "train_surrogate"): (
        "w0", "masks", "outputs", "kernels", "num_valid", "lr", "l1_lambda", "weight_decay"),
    ("explain.wlm", "shap_kernel"): ("mask", "num_valid_columns", "normalized"),
    ("explain.explainer", "weight_stacking"): ("weights",),
}


def check() -> None:
    """Raise ``RuntimeError`` where a pinned function is gone or its
    parameters differ from :data:`PINNED`."""
    for (module, name), want in PINNED.items():
        mod = importlib.import_module(f"{PACKAGE}.{module}")
        fn = getattr(mod, name, None)
        got = tuple(inspect.signature(fn).parameters) if fn is not None else None
        if got != want:
            raise RuntimeError(f"{PACKAGE}.{module}.{name} is {got}, the benchmark expects "
                               f"{want}: bring bench_port up to date with it")
