"""``FasterSparseEngine.cotr_corr_multiscale``: one pair a call, its
``queries`` keypoints forced, refined by squads. The traffic's ``engine``
block holds the engine's options and ``call`` any further keyword of the
call. The engine's random stream starts from the pair's own seed at each
call, so a call's work follows from its pair alone."""

import numpy as np

from cotr_bench import check
from cotr_bench.drivers import ServeDriver


class Driver(ServeDriver):

    site = staticmethod(check.squad_gaps)

    def make_engine(self):
        from cotr_tpu_torch.inference.engine import FasterSparseEngine

        return FasterSparseEngine(self.runner, seed=self.engine_seed,
                                  **self.traffic["engine"])

    def _install(self) -> None:
        super()._install()
        stepper = self.engine._stepper
        orig = stepper.dispatch

        def recorded(img_a, img_b, boxes_from, boxes_to, queries):
            out = orig(img_a, img_b, boxes_from, boxes_to, queries)
            if self.current is not None:
                self.current["dispatch"].append(
                    (None, boxes_from, boxes_to, queries, out))
            return out

        stepper.dispatch = recorded

    def call(self, pool_pairs, seeds):
        p = pool_pairs[0]
        self.engine.rng = np.random.RandomState(seeds[0])
        kw = dict(zoom_ins=self.zooms, queries_a=p.queries, force=True,
                  max_corrs=int(self.traffic["queries"]))
        kw.update(self.traffic.get("call", {}))
        return [self.engine.cotr_corr_multiscale(p.img_a, p.img_b, **kw)]

    def dense_pairs(self, rec):
        return [(self.pool[j].dev_a, self.pool[j].dev_b)
                for j in rec["pairs"]]
