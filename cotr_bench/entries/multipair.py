"""``FasterSparseEngine.cotr_corr_multiscale_multipair``:
``pairs_per_call`` pairs a call, ``queries`` keypoints each, forced; one
batched dense seed pass and squads formed across the pairs. Each pair
draws from its own seed (``pair_seeds``)."""

from cotr_bench import check
from cotr_bench.drivers import ServeDriver


class Driver(ServeDriver):

    site = staticmethod(check.squad_gaps)

    @property
    def pairs_per_call(self) -> int:
        return int(self.traffic["pairs_per_call"])

    def make_engine(self):
        from cotr_tpu_torch.inference.engine import FasterSparseEngine

        return FasterSparseEngine(self.runner, seed=self.engine_seed,
                                  **self.traffic["engine"])

    def _install(self) -> None:
        super()._install()
        stepper = self.engine._stepper
        orig = stepper.dispatch_indexed

        def recorded(imgs_a, imgs_b, idx, boxes_from, boxes_to, queries):
            out = orig(imgs_a, imgs_b, idx, boxes_from, boxes_to, queries)
            if self.current is not None:
                self.current["dispatch"].append(
                    (idx, boxes_from, boxes_to, queries, out))
            return out

        stepper.dispatch_indexed = recorded

    def call(self, pool_pairs, seeds):
        kw = dict(zoom_ins=self.zooms,
                  queries_list=[p.queries for p in pool_pairs], force=True,
                  max_corrs=int(self.traffic["queries"]), pair_seeds=seeds)
        kw.update(self.traffic.get("call", {}))
        return self.engine.cotr_corr_multiscale_multipair(
            [(p.img_a, p.img_b) for p in pool_pairs], **kw)

    def dense_pairs(self, rec):
        return [(self.pool[j].dev_a, self.pool[j].dev_b)
                for j in rec["pairs"]]
