"""lux_tpu_torch.analysis — model checking of the port's protocols
(``analysis.proto``)."""
