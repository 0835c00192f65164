"""Convert an upstream PyTorch diffusion checkpoint to the flax .ckpt that
the presets' ``diffusion.model_path`` names, without JAX.

The port's counterpart of ``tools/convert_torch_checkpoint.py``, with its
flags. The upstream trainer saves ``model-<k>.pt`` dicts with keys
``{step, model, opt, ema, scaler, version}``; ``model`` holds the
GaussianDiffusion state dict, whose U-Net weights live under ``model.``,
and ``ema`` the EMA wrapper's, under ``ema_model.model.``. This tool maps
those tensors onto the flax parameter tree of the U-Net (the names of
``red_diffeq_tpu_torch.models.unet.Unet``'s modules) and writes it with the
port's msgpack writer (``io/checkpoints.py:save_params``), a file that
``load_diffusion_params`` of either package reads.

Layout transforms:
* Conv2d (O, I, kh, kw)      -> flax kernel (kh, kw, I, O)
* Linear (O, I)              -> flax kernel (I, O)
* GroupNorm weight/bias      -> scale/bias
* RMSNorm g (1, C, 1, 1)     -> (1, 1, 1, C)
* the 1x1 conv after space-to-depth: the upstream Rearrange packs its input
  channels as (c, p1, p2), the U-Net's space_to_depth as (p1, p2, c), so
  the I axis is permuted.

:func:`to_upstream` is the inverse (a flax tree to an upstream U-Net state
dict), with which a prior can be written out in the upstream layout.

Usage:
    python tools/torch_convert_checkpoint.py model-4.pt model-4.ckpt \\
        [--source ema|model] [--dim 64] [--dim-mults 1 2 4 8] [--channels 1]
"""
import argparse
import pickle
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def conv_w(t):
    return np.transpose(np.asarray(t), (2, 3, 1, 0))


def dense_w(t):
    return np.transpose(np.asarray(t), (1, 0))


def rms_g(t):
    return np.transpose(np.asarray(t), (0, 2, 3, 1))


def _s2d_perm(o, c, t, to_flax):
    """Permute the packed input channels of a (O, 4C, 1, 1) weight between
    the upstream (c, p1, p2) order and space_to_depth's (p1, p2, c)."""
    t = np.asarray(t)
    assert t.shape[1] == 4 * c, (t.shape, c)
    if to_flax:
        t = t.reshape(o, c, 2, 2, 1, 1).transpose(0, 2, 3, 1, 4, 5)
    else:
        t = t.reshape(o, 2, 2, c, 1, 1).transpose(0, 3, 1, 2, 4, 5)
    return t.reshape(o, 4 * c, 1, 1)


def downsample_conv_w(t, base_channels):
    """The 1x1 conv after space-to-depth: the packed input channels from
    the upstream (c, p1, p2) order to (p1, p2, c), then conv_w."""
    t = np.asarray(t)
    return conv_w(_s2d_perm(t.shape[0], base_channels, t, to_flax=True))


def _pair(sd, key):
    return {'kernel': conv_w(sd[f'{key}.weight']),
            'bias': np.asarray(sd[f'{key}.bias'])}


def _block(sd, prefix):
    """One ``Block`` (proj conv + group norm)."""
    return {'proj': _pair(sd, f'{prefix}.proj'),
            'norm': {'scale': np.asarray(sd[f'{prefix}.norm.weight']),
                     'bias': np.asarray(sd[f'{prefix}.norm.bias'])}}


def _resnet_block(sd, prefix):
    out = {
        'time_mlp': {'kernel': dense_w(sd[f'{prefix}.mlp.1.weight']),
                     'bias': np.asarray(sd[f'{prefix}.mlp.1.bias'])},
        'block1': _block(sd, f'{prefix}.block1'),
        'block2': _block(sd, f'{prefix}.block2'),
    }
    if f'{prefix}.res_conv.weight' in sd:
        out['res_conv'] = _pair(sd, f'{prefix}.res_conv')
    return out


def _attention(sd, prefix, full: bool):
    out = {'norm': {'g': rms_g(sd[f'{prefix}.norm.g'])},
           'mem_kv': np.asarray(sd[f'{prefix}.mem_kv']),
           'to_qkv': {'kernel': conv_w(sd[f'{prefix}.to_qkv.weight'])}}
    if full:
        out['to_out'] = _pair(sd, f'{prefix}.to_out')
    else:
        out['to_out'] = _pair(sd, f'{prefix}.to_out.0')
        out['out_norm'] = {'g': rms_g(sd[f'{prefix}.to_out.1.g'])}
    return out


def _full_attn(dim_mults, full_attn):
    n = len(dim_mults)
    return (tuple(full_attn) if full_attn is not None
            else (False,) * (n - 1) + (True,))


def convert_state_dict(sd, dim: int, dim_mults, channels: int = 1,
                       full_attn=None):
    """Upstream U-Net state dict (un-prefixed keys, numpy values) -> flax
    parameter tree."""
    del channels      # read from the tensors' shapes
    n = len(dim_mults)
    full_attn = _full_attn(dim_mults, full_attn)
    dims = [dim] + [dim * m for m in dim_mults]
    params = {
        'init_conv': _pair(sd, 'init_conv'),
        'time_dense_0': {'kernel': dense_w(sd['time_mlp.1.weight']),
                         'bias': np.asarray(sd['time_mlp.1.bias'])},
        'time_dense_1': {'kernel': dense_w(sd['time_mlp.3.weight']),
                         'bias': np.asarray(sd['time_mlp.3.bias'])},
        'mid_block1': _resnet_block(sd, 'mid_block1'),
        'mid_attn': _attention(sd, 'mid_attn', full=True),
        'mid_block2': _resnet_block(sd, 'mid_block2'),
        'final_res_block': _resnet_block(sd, 'final_res_block'),
        'final_conv': _pair(sd, 'final_conv'),
    }
    for i in range(n):
        params[f'down_{i}_block1'] = _resnet_block(sd, f'downs.{i}.0')
        params[f'down_{i}_block2'] = _resnet_block(sd, f'downs.{i}.1')
        params[f'down_{i}_attn'] = _attention(sd, f'downs.{i}.2',
                                              full=full_attn[i])
        if i == n - 1:
            params[f'down_{i}_downsample'] = _pair(sd, f'downs.{i}.3')
        else:
            params[f'down_{i}_downsample'] = {
                'kernel': downsample_conv_w(sd[f'downs.{i}.3.1.weight'],
                                            dims[i]),
                'bias': np.asarray(sd[f'downs.{i}.3.1.bias'])}
    rev_full = tuple(reversed(full_attn))
    for i in range(n):
        params[f'up_{i}_block1'] = _resnet_block(sd, f'ups.{i}.0')
        params[f'up_{i}_block2'] = _resnet_block(sd, f'ups.{i}.1')
        params[f'up_{i}_attn'] = _attention(sd, f'ups.{i}.2',
                                            full=rev_full[i])
        key = f'ups.{i}.3' if i == n - 1 else f'ups.{i}.3.1'
        params[f'up_{i}_upsample'] = _pair(sd, key)
    return params


def to_upstream(params, dim: int, dim_mults, full_attn=None) -> dict:
    """The inverse of :func:`convert_state_dict`: a flax U-Net parameter
    tree -> the upstream U-Net state dict (un-prefixed keys, numpy)."""
    n = len(dim_mults)
    full_attn = _full_attn(dim_mults, full_attn)
    dims = [dim] + [dim * m for m in dim_mults]
    sd = {}

    def conv(key, leaf, kernel=None):
        k = np.asarray(leaf['kernel'] if kernel is None else kernel)
        sd[f'{key}.weight'] = np.ascontiguousarray(k.transpose(3, 2, 0, 1))
        sd[f'{key}.bias'] = np.asarray(leaf['bias'])

    def dense(key, leaf):
        sd[f'{key}.weight'] = np.ascontiguousarray(
            np.asarray(leaf['kernel']).T)
        sd[f'{key}.bias'] = np.asarray(leaf['bias'])

    def g(key, leaf):
        sd[key] = np.ascontiguousarray(
            np.asarray(leaf['g']).transpose(0, 3, 1, 2))

    def resnet(prefix, p):
        dense(f'{prefix}.mlp.1', p['time_mlp'])
        for b in ('block1', 'block2'):
            conv(f'{prefix}.{b}.proj', p[b]['proj'])
            sd[f'{prefix}.{b}.norm.weight'] = np.asarray(p[b]['norm']['scale'])
            sd[f'{prefix}.{b}.norm.bias'] = np.asarray(p[b]['norm']['bias'])
        if 'res_conv' in p:
            conv(f'{prefix}.res_conv', p['res_conv'])

    def attention(prefix, p, full):
        g(f'{prefix}.norm.g', p['norm'])
        sd[f'{prefix}.mem_kv'] = np.asarray(p['mem_kv'])
        sd[f'{prefix}.to_qkv.weight'] = np.ascontiguousarray(
            np.asarray(p['to_qkv']['kernel']).transpose(3, 2, 0, 1))
        if full:
            conv(f'{prefix}.to_out', p['to_out'])
        else:
            conv(f'{prefix}.to_out.0', p['to_out'])
            g(f'{prefix}.to_out.1.g', p['out_norm'])

    conv('init_conv', params['init_conv'])
    dense('time_mlp.1', params['time_dense_0'])
    dense('time_mlp.3', params['time_dense_1'])
    for i in range(n):
        resnet(f'downs.{i}.0', params[f'down_{i}_block1'])
        resnet(f'downs.{i}.1', params[f'down_{i}_block2'])
        attention(f'downs.{i}.2', params[f'down_{i}_attn'], full_attn[i])
        p = params[f'down_{i}_downsample']
        if i == n - 1:
            conv(f'downs.{i}.3', p)
        else:
            k = np.asarray(p['kernel']).transpose(3, 2, 0, 1)
            k = _s2d_perm(k.shape[0], dims[i], k, to_flax=False)
            conv(f'downs.{i}.3.1', p, kernel=k.transpose(2, 3, 1, 0))
    resnet('mid_block1', params['mid_block1'])
    attention('mid_attn', params['mid_attn'], True)
    resnet('mid_block2', params['mid_block2'])
    rev_full = tuple(reversed(full_attn))
    for i in range(n):
        resnet(f'ups.{i}.0', params[f'up_{i}_block1'])
        resnet(f'ups.{i}.1', params[f'up_{i}_block2'])
        attention(f'ups.{i}.2', params[f'up_{i}_attn'], rev_full[i])
        conv(f'ups.{i}.3' if i == n - 1 else f'ups.{i}.3.1',
             params[f'up_{i}_upsample'])
    resnet('final_res_block', params['final_res_block'])
    conv('final_conv', params['final_conv'])
    return sd


def strip_prefix(state_dict, source: str):
    """The U-Net tensors: 'model' -> 'model.*', 'ema' ->
    'ema_model.model.*' (ema-pytorch) or 'ema_model.online_model.model.*'."""
    prefixes = {'model': ['model.'],
                'ema': ['ema_model.model.', 'ema_model.online_model.model.']}
    for prefix in prefixes[source]:
        sub = {k[len(prefix):]: v for k, v in state_dict.items()
               if k.startswith(prefix)}
        if sub:
            return sub
    raise KeyError(f'no U-Net weights found for source={source}')


def load_torch_checkpoint(path):
    """``torch.load`` of ``path`` on the CPU, with ``weights_only=True``
    where the file allows it (tensors, dicts, numbers and strings); a file
    that holds other objects is read in full, with a line saying so."""
    import torch
    try:
        return torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError as e:
        print(f'{path} holds objects beyond tensors ({str(e)[:120]}...); '
              'reading it in full', flush=True)
        return torch.load(path, map_location='cpu', weights_only=False)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('torch_ckpt', type=Path)
    p.add_argument('out_ckpt', type=Path)
    p.add_argument('--source', choices=['model', 'ema'], default='model')
    p.add_argument('--dim', type=int, default=64)
    p.add_argument('--dim-mults', type=int, nargs='+', default=[1, 2, 4, 8])
    p.add_argument('--channels', type=int, default=1)
    args = p.parse_args(argv)

    from red_diffeq_tpu_torch.io.checkpoints import save_params

    data = load_torch_checkpoint(args.torch_ckpt)
    state = data[args.source] if args.source in data else data
    if hasattr(state, 'items'):
        state = {k: v.numpy() if hasattr(v, 'numpy') else v
                 for k, v in state.items()}
    sd = strip_prefix(state, args.source)
    params = convert_state_dict(sd, args.dim, tuple(args.dim_mults),
                                args.channels)
    save_params(params, args.out_ckpt)
    print(f'Converted {args.torch_ckpt} ({args.source}) -> {args.out_ckpt}')
    return params


if __name__ == '__main__':
    main()
