from mppi_generic_tpu_torch.nn.fnn import FNN

__all__ = ["FNN"]
