"""The plain reference of the benchmark: plain PyTorch in float32, written
from the architecture's description and the configuration, importing
nothing of the program. :mod:`.model` is the MoE decoder and its loss,
:mod:`.mamba2` the Mamba-2 LM and its loss, :mod:`.train` the training
steps that the program's first steps are held to."""
