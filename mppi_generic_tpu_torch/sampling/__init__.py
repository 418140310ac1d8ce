from mppi_generic_tpu_torch.sampling.base import SamplingDistribution
from mppi_generic_tpu_torch.sampling.colored import ColoredNoiseDistribution
from mppi_generic_tpu_torch.sampling.gaussian import GaussianDistribution
from mppi_generic_tpu_torch.sampling.nln import NLNDistribution
from mppi_generic_tpu_torch.sampling.smooth import SmoothMPPIDistribution

__all__ = ["SamplingDistribution", "ColoredNoiseDistribution", "GaussianDistribution",
           "NLNDistribution", "SmoothMPPIDistribution"]
