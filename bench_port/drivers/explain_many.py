"""Drives the program's multi-query entry, ``explain_many``, one call after
another.

Each call sends ``queries_per_call`` genes with the mix of subgraph
classes of :mod:`bench_port.strata`; no gene is sent twice in a run, so no
call is served from the program's launch-plan cache.  Warm-up calls take
their genes from the same schedule, so they make the stacks, shapes and
pinned buffers the timed calls use.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from bench_port.drivers import common


class Driver(common.Base):
    """One client sending whole calls, the next when the last returned."""

    def setup(self) -> None:
        ctx = self.ctx
        from bikg_graph_explainability_public_tpu_torch.explain import batch

        from bench_port import program_api

        program_api.check()  # the traced window reaches batch's private functions
        self._batch = batch
        with ctx.part("graph"):
            self.graph = ctx.family.program_graph(ctx.gg, ctx.model_cfg, ctx.device)
            self.model = ctx.family.program_model(ctx.model_cfg, ctx.params, ctx.device)
            self.names = ctx.gg.names()
        with ctx.part("warmup"):
            for _ in range(int(self.traffic["warmup_calls"])):
                self._call(self.schedule.next_round())

    def _call(self, genes: List[int], timer=None):
        """``explain_many`` on ``genes``: its frames, one a gene.  With a
        ``timer`` (a traced window), the same through ``_explain_many``,
        whose phases it times, and the frames built as ``explain_many``
        builds them."""
        if self.traffic["mode"] != "shapley":
            raise ValueError("this driver sends Shapley-mode calls only")
        args = (self.model, self.graph, genes, self.explain_cfg)
        kw = dict(names=self.names, times=int(self.traffic["times"]))
        if timer is None:
            frames = self._batch.explain_many(*args, **kw)
        else:
            frames = self._batch._assemble_dfs(self._batch._explain_many(*args, **kw, timer=timer))
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        return frames

    def window(self, seconds: float, trace: bool) -> Dict:
        """Whole calls from the first after warm-up until the first that
        ends at or after ``seconds``."""
        from bikg_graph_explainability_public_tpu_torch.utils.profiling import PhaseTimer

        timer = PhaseTimer() if trace else None
        calls, failed, attempted = 0, 0, 0
        answers, call_s = [], []
        prof_calls = prof_expl = 0
        prof_flops = 0.0
        with self.profile_slice(trace) as slice_:
            t0 = time.perf_counter()
            while True:
                genes = self.schedule.next_round()
                attempted += len(genes)
                t = time.perf_counter()
                try:
                    exs = self._call(genes, timer)
                except Exception:  # noqa: BLE001 - a failed call is counted and shown
                    failed += len(genes)
                    self.show_failure()
                    exs = None
                calls += 1
                call_s.append(time.perf_counter() - t)
                if exs is not None:
                    for pos, (g, frame) in enumerate(zip(genes, exs)):
                        answers.append(dict(self.frame_answer(g, frame), position=pos))
                if slice_.active:
                    prof_calls += 1
                    prof_expl += len(genes)
                    prof_flops += self.flops(genes)
                    slice_.maybe_stop()
                if time.perf_counter() - t0 >= seconds:
                    break
        window_s = time.perf_counter() - t0
        self.answers = answers
        done = len(answers)
        return {
            "entry": "explain_many", "window_s": window_s, "calls": calls,
            "explanations": done, "attempted": attempted, "failed": failed, "call_s": call_s,
            "phases_s": dict(timer.totals) if timer else None,
            "profile": slice_.summary(prof_calls, prof_expl, prof_flops),
        }

    def free(self) -> None:
        del self.model, self.graph

    def reference_scores(self, answer, prec):
        from bench_port.reference import explain as rx

        sub = self.reference_subgraph(answer["gene"])
        return sub, rx.explain_many_shapley(self.ctx.ref_family, self.ctx.params, self.ref_x, sub,
                                            self.explain_cfg, answer["position"],
                                            int(self.traffic["times"]), prec)
