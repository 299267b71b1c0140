"""The port's train step (``make_train_step``) at the traffic's batch, on a
pool of batches of the synthetic recipe's crop layout made on the card in
set-up. Set-up takes the first ``checked_steps`` steps through the
window's own call on distinct batches and keeps what the comparison reads:
each step's loss, the first gradient as Adam got it (its first moment
after one step, read through the optimizer's ``state_dict()``, over
1 - beta1 of the published Adam) and the trainable weights before the
first step and after the last checked one."""

import torch

from cotr_bench import pairs as gen
from cotr_bench.drivers import Spans, program_model
from cotr_bench.reference.train import BETA1


class Driver:

    kind = "train"
    program_state = ("state", "step_fn")

    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic = ctx.traffic
        self.spans = Spans()
        self.steps_run = 0

    def build(self) -> None:
        from cotr_tpu_torch.config import TrainConfig
        from cotr_tpu_torch.training.train_step import (create_train_state,
                                                        make_train_step)

        t = self.traffic
        self.train_cfg = TrainConfig(batch_size=int(t["batch"]),
                                     num_kp=int(t["num_kp"]),
                                     bidirectional=bool(t["bidirectional"]),
                                     cycle_consis=True)
        self.state = create_train_state(program_model(self.ctx),
                                        self.train_cfg,
                                        device=self.ctx.device)
        self.step_fn = make_train_step(self.train_cfg)
        self.batches = [gen.make_train_batch(self.ctx.seed, i, t,
                                             self.ctx.device)
                        for i in range(int(t["pool"]))]
        self.gen_seed = int(gen.rng_for(self.ctx.seed, 4).integers(
            0, 2 ** 62))
        self.generator = torch.Generator(device=self.ctx.device) \
            .manual_seed(self.gen_seed)
        opt = self.state.optimizer
        self.p0 = {n: p.detach().clone() for n, p in opt.params.items()}
        self.losses = []
        for s in range(int(t["checked_steps"])):
            self.request(s)
            self.losses.append(self.last_loss)
            if s == 0:
                self.grad1 = {n: m / (1.0 - BETA1) for n, m in
                              opt.state_dict()["mu"].items()}
        self.p_checked = {n: p.detach().clone()
                          for n, p in opt.params.items()}

    def warm_up(self, sync) -> int:
        """The checked steps of set-up ran every shape of the window."""
        return 0

    def counters(self) -> dict:
        return {}

    def request(self, i: int, keep: bool = True) -> int:
        batch = self.batches[self.steps_run % len(self.batches)]
        self.state, metrics = self.step_fn(self.state, batch, self.generator)
        self.last_loss = metrics["loss"]
        self.steps_run += 1
        return int(self.traffic["batch"])

    def after_window(self) -> dict:
        return {"failed": 0, "pool_errors": None}

    def free(self) -> None:
        for attr in self.program_state:
            if hasattr(self, attr):
                delattr(self, attr)

    def numbers(self, under_test=None) -> dict:
        from cotr_bench import check

        return check.train_numbers(self, under_test)
