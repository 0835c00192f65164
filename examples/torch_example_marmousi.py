"""Marmousi field-scale example with the PyTorch port (counterpart of
``examples/example_marmousi.py``): 70x190 model with the patched diffusion
regularizer, through ``red_diffeq_tpu_torch.cli.run_inversion``. Flags as
``examples/torch_example_openfwi.py``."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_example_openfwi import main  # noqa: E402

if __name__ == '__main__':
    main(config='configs/marmousi/red-diffeq.yaml',
         results_dir='experiment/example_marmousi', name='example_marmousi')
