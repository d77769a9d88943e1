"""Drives the program's single-query entry, ``Explainer.run``, one request
after another: one analyst, a closed loop.

Requests go round a cycle of ``cycle`` genes with the mix of subgraph
classes of :mod:`bench_port.strata`, each cycle in another order drawn
from the seed, no gene twice in a run; the window is whole cycles.  Warm-up sends one gene of every
class of the mix.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from bench_port.drivers import common


class Driver(common.Base):
    """One client, each request sent when the last returned."""

    def setup(self) -> None:
        ctx = self.ctx
        from bikg_graph_explainability_public_tpu_torch.explain.explainer import Explainer

        if self.traffic["mode"] != "shapley":
            raise ValueError("this driver sends Shapley-mode requests only")
        with ctx.part("graph"):
            self.names = ctx.gg.names()
            self.model = ctx.family.program_model(ctx.model_cfg, ctx.params, ctx.device)
            args = ctx.family.explainer_args(ctx.gg, ctx.model_cfg, self.names)
            self.explainer = Explainer(args.pop("feat"), args.pop("edge_index"), self.model,
                                       self.explain_cfg, args.pop("names"), device=ctx.device,
                                       **args)
        self._queue = []
        with ctx.part("warmup"):
            for _ in range(int(self.traffic["warmup_rounds"])):
                for g in self.schedule.one_of_each():
                    self._request(g, False)

    def _next(self) -> int:
        if not self._queue:
            self._queue = self.schedule.next_round()
        return self._queue.pop(0)

    def _request(self, gene: int, diagnostics: bool):
        out = self.explainer.run(self.names[gene], int(self.traffic["times"]),
                                 return_diagnostics=diagnostics)
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        return out

    def window(self, seconds: float, trace: bool) -> Dict:
        """Whole cycles of requests, from the first after warm-up until the
        first cycle that ends at or after ``seconds``: every run of the cell
        sends the same mix of classes."""
        lat, answers, phases = [], [], {}
        failed = attempted = 0
        with self.profile_slice(trace) as slice_:
            t0 = time.perf_counter()
            while True:
                gene = self._next()
                attempted += 1
                t = time.perf_counter()
                try:
                    out = self._request(gene, trace)
                except Exception:  # noqa: BLE001 - a failed request is counted and shown
                    failed += 1
                    self.show_failure()
                    out = None
                lat.append(time.perf_counter() - t)
                if out is not None:
                    answers.append(self.frame_answer(gene, out[0]))
                    diag = out[2] if trace else None
                    for k, v in (diag or {}).get("phase_seconds", {}).items():
                        phases[k] = phases.get(k, 0.0) + v
                if slice_.active:
                    slice_.add([gene])
                if not self._queue and time.perf_counter() - t0 >= seconds:
                    break
        self.answers = answers
        return {
            "entry": "explain_run", "window_s": time.perf_counter() - t0,
            "requests": len(lat), "latencies_s": lat, "explanations": len(answers),
            "attempted": attempted, "failed": failed,
            "phases_s": phases if trace else None,
            "profile": self.profile(slice_),
        }

    def free(self) -> None:
        del self.explainer, self.model

    def reference_scores(self, answer, prec):
        from bench_port.reference import explain as rx

        sub = self.reference_subgraph(answer["gene"])
        return sub, rx.explain_run_shapley(self.ctx.ref_family, self.ctx.params, self.ref_x, sub,
                                           self.explain_cfg, int(self.traffic["times"]), prec)
