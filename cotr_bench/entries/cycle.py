"""``SparseEngine.cotr_corr_multiscale_with_cycle_consistency``: one pair
a call, ``max_corrs`` seeds drawn from the dense pass, refined a row of
crops at a time both ways. The engine's random stream starts from the
pair's own seed at each call, so a call's work follows from its pair
alone."""

import numpy as np

from cotr_bench import check
from cotr_bench.drivers import ServeDriver


class Driver(ServeDriver):

    site = staticmethod(check.scan_gaps)

    def make_engine(self):
        from cotr_tpu_torch.inference.engine import SparseEngine

        return SparseEngine(self.runner, seed=self.engine_seed,
                            **self.traffic["engine"])

    def _install(self) -> None:
        super()._install()
        eng = self.engine
        orig_all = eng._refine_all
        direction = {"forward": True}

        def refine_all(img_a, img_b, *args, **kw):
            rec = self.current
            if rec is not None:
                direction["forward"] = \
                    img_a is self.pool[rec["pairs"][0]].img_a
            return orig_all(img_a, img_b, *args, **kw)

        orig_refine = eng.refiner.refine

        def refine(img_a, hw_a, img_b, hw_b, loc_from, loc_to0, s_from, s_to,
                   zooms, converge_iters=1):
            hist = orig_refine(img_a, hw_a, img_b, hw_b, loc_from, loc_to0,
                               s_from, s_to, zooms, converge_iters)
            if self.current is not None:
                self.current["refine"].append(dict(
                    forward=direction["forward"],
                    loc_from=np.asarray(loc_from, np.float64),
                    loc_to0=np.asarray(loc_to0, np.float64),
                    s_from=float(s_from), s_to=float(s_to),
                    zooms=list(zooms), iters=int(converge_iters),
                    history=hist))
            return hist

        eng._refine_all = refine_all
        eng.refiner.refine = refine

    def call(self, pool_pairs, seeds):
        p = pool_pairs[0]
        self.engine.rng = np.random.RandomState(seeds[0])
        kw = dict(zoom_ins=self.zooms,
                  max_corrs=int(self.traffic["max_corrs"]))
        kw.update(self.traffic.get("call", {}))
        return [self.engine.cotr_corr_multiscale_with_cycle_consistency(
            p.img_a, p.img_b, **kw)]

    def dense_pairs(self, rec):
        p = self.pool[rec["pairs"][0]]
        return [(p.dev_a, p.dev_b), (p.dev_b, p.dev_a)]
