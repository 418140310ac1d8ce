from mppi_generic_tpu_torch.nn.fnn import FNN
from mppi_generic_tpu_torch.nn.lstm import LSTM, LSTMLSTM

__all__ = ["FNN", "LSTM", "LSTMLSTM"]
