"""Write the frozen FID feature weights of the JAX trainer for the port.

The JAX trainer's FID proxy (``red_diffeq_tpu/models/trainer.py:51-86``)
draws its four 3x3 stride-2 conv kernels from ``jax.random`` with the fixed
seed 0x5EED. The port cannot draw them without JAX, so it reads them from
``red_diffeq_tpu_torch/models/fid_weights.npy``: the four HWIO kernels
(3, 3, 1, 16), (3, 3, 16, 32), (3, 3, 32, 64), (3, 3, 64, 128) raveled and
concatenated in that order as one float32 array of 96912 values. This tool
writes that file from ``_frozen_feature_weights()``; run it once, on a
machine with the JAX package (JAX_PLATFORMS=cpu is enough):

    JAX_PLATFORMS=cpu python tools/write_fid_weights.py
"""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from red_diffeq_tpu.models.trainer import _frozen_feature_weights  # noqa: E402

OUT = ROOT / 'red_diffeq_tpu_torch' / 'models' / 'fid_weights.npy'


def main():
    flat = np.concatenate([np.asarray(w, np.float32).ravel()
                           for w in _frozen_feature_weights()])
    np.save(OUT, flat)
    print(f'wrote {flat.size} float32 values to {OUT}')


if __name__ == '__main__':
    main()
