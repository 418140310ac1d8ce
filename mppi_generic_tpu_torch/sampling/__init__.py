from mppi_generic_tpu_torch.sampling.base import SamplingDistribution
from mppi_generic_tpu_torch.sampling.gaussian import GaussianDistribution

__all__ = ["SamplingDistribution", "GaussianDistribution"]
