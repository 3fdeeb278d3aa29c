"""mcintegration — an adaptive Monte Carlo integration framework for GPUs.

A from-scratch JAX/XLA re-design with the capabilities of
numericalEFT/MCIntegration.jl: three solvers (:vegas importance sampling,
:vegasmc hybrid Vegas+Markov-chain, :mcmc Metropolis over multiple
integrands), the variable-pool DSL (Continuous / Discrete / FermiK /
CompositeVar with dof specs and padding-probability algebra), adaptive Vegas
maps, reweighting, per-block error estimation and chi^2-pooled iteration
averages — built around vectorized walker batches, counter-based RNG and
single-collective statistics reduction over a device mesh.
"""

from .common import onehot
from .configuration import Configuration
from .main import clear_kernel_cache, integrate
from .models.variable import CompositeVar, Continuous, Discrete, FermiK
from .statistics import Result, average, report
from .checkpoint import load_state, save_state
from .parallel.mesh import default_mesh, init_distributed, make_mesh

__version__ = "0.1.0"

__all__ = [
    "Configuration",
    "Continuous",
    "Discrete",
    "CompositeVar",
    "FermiK",
    "Result",
    "integrate",
    "clear_kernel_cache",
    "onehot",
    "report",
    "average",
    "save_state",
    "load_state",
    "default_mesh",
    "make_mesh",
    "init_distributed",
]
