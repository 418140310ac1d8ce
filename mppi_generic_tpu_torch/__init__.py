"""mppi_generic_tpu_torch: the PyTorch + CUDA port of mppi_generic_tpu.

The JAX package stays the reference. This package mirrors its layout and
names; its hot path runs hand-written CUDA kernels for Hopper (``csrc/``),
built at first use. Entry points run on the GPU unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from mppi_generic_tpu_torch.controllers.vanilla import VanillaMPPI
from mppi_generic_tpu_torch.costs.base import Cost
from mppi_generic_tpu_torch.models.base import Dynamics
from mppi_generic_tpu_torch.sampling.base import SamplingDistribution
from mppi_generic_tpu_torch.sampling.gaussian import GaussianDistribution

__all__ = [
    "Dynamics",
    "Cost",
    "SamplingDistribution",
    "GaussianDistribution",
    "VanillaMPPI",
]
