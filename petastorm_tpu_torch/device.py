"""Device resolution: entry points take ``device=`` and default to CUDA."""

import torch


def resolve_device(device='cuda'):
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (there is no CPU fallback: pass ``device='cpu'`` explicitly)."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("device {!r} requested but torch.cuda.is_available() is False; "
                               "pass device='cpu' to run on the host".format(str(device)))
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError('petastorm_tpu_torch runs on cuda or cpu, got {!r}'.format(str(device)))
    return dev
