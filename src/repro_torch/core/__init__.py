"""MIREDO core: the paper's contribution (arch abstraction, flexible
factorization, analytical latency model, MIP formulation, baselines)."""

from repro_torch.core.arch import CimArch, default_arch, INPUT, WEIGHT, OUTPUT
from repro_torch.core.workload import Layer, conv, gemm
from repro_torch.core.mapping import Mapping
from repro_torch.core.frontend import (ModelWorkload, extract_all,
                                 extract_workload, optimize_model)
from repro_torch.core.scheduler import Schedule, schedule_network
