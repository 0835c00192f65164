"""Post-hoc aggregation of saved inversion results.

Counterpart of ``red_diffeq_tpu/io/results.py`` (plain numpy, copied):
collect per-sample metric curves from ``*_results.npz`` run directories and
average them, per OpenFWI family (CF/CV/FF/FV) or for a single field-scale
dataset (Marmousi/Overthrust).
"""
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

OPENFWI_FAMILIES = ('CF', 'CV', 'FF', 'FV')


def _collect(npz_files) -> Optional[Dict[str, list]]:
    curves = {'mae': [], 'rmse': [], 'ssim': []}
    for npz_file in npz_files:
        try:
            data = np.load(npz_file)
            # Read every key BEFORE appending any: a partial file (e.g.
            # 'mae' present but 'rmse' missing) must be skipped whole,
            # not leave the per-metric lists misaligned so aggregates
            # silently average different sample sets per metric.
            loaded = {k: data[k] for k in curves}
        except Exception as e:  # pragma: no cover - corrupt file guard
            print(f'Warning: Failed to load {npz_file}: {e}')
            continue
        for k, v in loaded.items():
            curves[k].append(v)
    return curves if curves['mae'] else None


def _aggregate(curves, return_final_only: bool):
    if return_final_only:
        return {
            'MAE': float(np.mean([c[-1] for c in curves['mae']])),
            'RMSE': float(np.mean([c[-1] for c in curves['rmse']])),
            'SSIM': float(np.mean([c[-1] for c in curves['ssim']])),
        }
    return {k: np.mean(v, axis=0) for k, v in curves.items()}


def load_openfwi(folder_path, return_final_only: bool = False,
                 families: Sequence[str] = OPENFWI_FAMILIES):
    """Average metric curves over all samples of all OpenFWI families in
    a run directory (reference visualization.py:8-47)."""
    folder_path = Path(folder_path)
    if not folder_path.exists():
        print(f'Error: Folder does not exist: {folder_path}')
        return None
    npz_files = []
    for family in families:
        fam_dir = folder_path / family
        if fam_dir.exists():
            npz_files += sorted(fam_dir.glob('*_results.npz'))
    curves = _collect(npz_files)
    if curves is None:
        print(f'Error: No valid npz files found in {folder_path}')
        return None
    return _aggregate(curves, return_final_only)


def load_marmousi(folder_path, return_final_only: bool = False):
    """Average metric curves for a Marmousi/Overthrust run directory
    (reference visualization.py:49-104)."""
    folder_path = Path(folder_path)
    if not folder_path.exists():
        print(f'Error: Folder does not exist: {folder_path}')
        return None
    subdirs = sorted((d for d in folder_path.iterdir()
                      if d.is_dir() and not d.name.startswith('.')
                      and d.name.lower() in ('marmousi', 'overthrust')),
                     key=lambda d: d.name.lower())
    if len(subdirs) > 1:
        # Deterministic choice + an explicit signal: iterdir() order is
        # filesystem-dependent, so silently taking "the first" would
        # report different datasets on different machines.
        print(f'Warning: multiple dataset subdirs in {folder_path} '
              f'({[d.name for d in subdirs]}); using {subdirs[0].name!r} '
              f'- pass the subdirectory itself to select the other')
    if subdirs:
        npz_files = sorted(subdirs[0].glob('*_results.npz'))
    else:
        npz_files = sorted(folder_path.glob('*_results.npz'))
    if not npz_files:
        print(f'Error: No npz files found in {folder_path}')
        return None
    curves = _collect(npz_files)
    if curves is None:
        print(f'Error: No valid data loaded from {folder_path}')
        return None
    return _aggregate(curves, return_final_only)
