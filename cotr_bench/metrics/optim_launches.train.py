"""Kernel launches (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
``cuLaunchKernel`` runtime calls of the window's thread) inside the train
step's ``cotr.train.optimizer`` spans, per span: the optimizer's launches a
step. Nothing on a trace without CUDA runtime events (a CPU run)."""

from cotr_bench import program_spans


def read(m):
    return program_spans.launches_per_span(m, "optim_launches.train",
                                           "cotr.train.optimizer")
