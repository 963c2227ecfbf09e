"""Plain PyTorch references of the benchmark's models. Nothing here imports
the program (nfdpm_tpu_torch) or JAX: every quantity the program derives
from the benchmark's inputs is worked out here again."""

import torch

DTYPE = torch.float64  # every check's reference runs in it
