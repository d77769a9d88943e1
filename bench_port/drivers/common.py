"""What the drivers share: the query schedule, the traced slice of the
window, the useful operations of an explanation, and the comparison with
the plain reference that decides ``correct``."""

from __future__ import annotations

import contextlib
import math
import os
import sys
import time
import traceback
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from bench_port import graphgen, strata, trace
from bench_port.reference import explain as rx


class Slice:
    """The profiled part of a traced window: from its first call until the
    first call that ends ``seconds`` after the profiler started."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.active = False
        self._prof = None
        self._ann = None
        self._t0 = 0.0

    def start(self) -> None:
        self._prof = trace.profiler()
        self._prof.__enter__()
        self._ann = torch.profiler.record_function(trace.WINDOW)
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        self._ann.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False

    def maybe_stop(self) -> None:
        """Stop once ``seconds`` have passed since the start (the
        profiler's own start-up is not counted)."""
        if time.perf_counter() - self._t0 >= self.seconds:
            self.stop()

    def summary(self, calls: int, explanations: int, flops: float) -> Optional[Dict]:
        """The profile's numbers with the work done inside it, or None for
        an untraced window."""
        if self._prof is None:
            return None
        out = trace.summarize(self._prof)
        out.update(calls=calls, explanations=explanations, useful_flops=flops)
        return out


class Base:
    """A driver of one entry of the program under a traffic mix.
    Subclasses define ``setup``, ``window``, ``free`` and
    ``reference_scores``."""

    def __init__(self, ctx, traffic: dict):
        self.ctx = ctx
        self.traffic = traffic
        self.explain_cfg = dict(traffic["explain"])
        self.answers: List[dict] = []
        hops = len(ctx.model_cfg["conv_channels"]) + 1
        with ctx.part("strata"):
            self.nodes, self.edges = strata.cached_sizes(
                ctx.cfg["graph"], ctx.gg.n, ctx.edges, hops, ctx.device,
                os.path.join(ctx.cache_dir, "strata"))
            classes = strata.classes_of(self.nodes, self.edges)
            per_round = int(traffic.get("queries_per_call") or traffic["cycle"])
            self.mix = strata.quota(classes, per_round)
            self.schedule = strata.Schedule(classes, self.mix, int(traffic["genes_seed"]),
                                            ctx.seed)
        self.hops = hops
        self._csr = graphgen.in_neighbour_csr(ctx.gg.n, ctx.edges)

    @contextlib.contextmanager
    def profile_slice(self, enabled: bool) -> Iterator[Slice]:
        s = Slice(float(self.traffic["trace_seconds"]))
        if enabled:
            s.start()
        try:
            yield s
        finally:
            s.stop()

    def flops(self, genes) -> float:
        """Useful operations of explaining ``genes`` (the yardstick of
        ``metrics/_opcount.py``)."""
        from bench_port.metrics import _opcount

        rows = int(self.explain_cfg["interpret_samples"]) * int(self.explain_cfg["epochs"])
        return sum(_opcount.explanation_flops(
            self.ctx.model_cfg, int(self.nodes[g]), int(self.edges[g]), rows,
            int(self.explain_cfg["epochs"]), int(self.traffic["times"])) for g in genes)

    @staticmethod
    def show_failure() -> None:
        traceback.print_exc(file=sys.stderr)

    # -- the comparison -----------------------------------------------------

    def reference_subgraph(self, gene: int) -> rx.Sub:
        ptr, col = self._csr
        nodes = graphgen.khop_nodes(ptr, col, int(gene), self.hops)
        return rx.subgraph(nodes, self.ctx.edges, self.ctx.etype, int(gene))

    def sample(self) -> List[dict]:
        """The answers the reference recomputes: the one with the largest
        subgraph and ``check_answers - 1`` more drawn from the seed."""
        if not self.answers:
            return []
        rng = np.random.default_rng([self.ctx.seed, 1])
        sizes = np.array([self.nodes[a["gene"]] for a in self.answers])
        first = int(np.argmax(sizes))
        rest = [i for i in rng.permutation(len(self.answers)) if i != first]
        k = int(self.traffic["check_answers"])
        return [self.answers[i] for i in [first] + rest[: k - 1]]

    @property
    def ref_x(self) -> torch.Tensor:
        """The graph's features on the device, for the reference (made once,
        after the window)."""
        if getattr(self, "_ref_x", None) is None:
            self._ref_x = torch.as_tensor(self.ctx.gg.x, device=self.ctx.device)
        return self._ref_x

    @staticmethod
    def frame_answer(gene: int, frame) -> dict:
        """An answer as the program's element-score frame gives it."""
        return {"gene": gene, "names": frame.index.to_numpy(),
                "scores": frame["config_value_mean"].to_numpy()}

    def compare(self, answers: List[dict], control=False) -> Dict[str, float]:
        """The numbers compared: ``names_mismatch``, the answers whose
        elements are not the reference subgraph's; ``score_gap`` and
        ``score_gap_p99``, each answer's median and 99th-percentile gap
        between its scores and the reference's (as a share of the median
        reference score's size), each taken at the 75th percentile over
        the answers, so that one answer in which float32 round-off is
        amplified by Adam does not decide, and a fault in a quarter of the
        answers or in 1 % of their elements does.  With ``control``, the
        reference in TF32 stands in for the program (with
        ``control="self"``, a second run of the float32 reference).
        ``last_gaps`` keeps each answer's (median, p99, widest) gap."""
        names = self.ctx.gg.names()
        mismatch = 0
        self.last_gaps = []
        for a in answers:
            sub, ref = self.reference_scores(a, rx.Precision(False))
            ref = ref.detach().cpu().numpy()
            if control:
                prec = rx.Precision(control != "self")
                got = self.reference_scores(a, prec)[1].detach().cpu().numpy()
            else:
                ref_names = [names[i] for i in sub.nodes]
                by_name = dict(zip(a["names"], a["scores"]))
                if len(by_name) != len(a["names"]) or set(by_name) != set(ref_names):
                    mismatch += 1
                    self.last_gaps.append((math.inf, math.inf, math.inf))
                    continue
                got = np.array([by_name[k] for k in ref_names])
            self.last_gaps.append(rx.gaps(got, ref))
        per = np.array(self.last_gaps, np.float64).reshape(-1, 3)

        def over_answers(col: int) -> float:
            # an answer's gap, not an interpolation; inf sorts above every gap
            return float(np.quantile(per[:, col], 0.75, method="higher")) if len(per) else math.inf

        return {"names_mismatch": float(mismatch), "score_gap": over_answers(0),
                "score_gap_p99": over_answers(1)}
