"""The system under test, as the benchmark builds it: the port's
recognizer from a configuration file's model dict, loaded strictly with
the benchmark's state dict, and the port's entries."""

from __future__ import annotations

from typing import Dict, Optional

import torch


def build_model(config: dict, state: Dict[str, torch.Tensor], device,
                quant: Optional[dict] = None) -> torch.nn.Module:
    """The port's recognizer of ``config['model']`` in the config's
    compute dtype, with ``fcn_testing`` (the dense test's path; training
    takes the standard path), on ``device``, holding ``state``. ``quant``
    adds backbone options (the int8 eval path)."""
    from mvfnet_tpu_torch.models import build_recognizer
    model_cfg = dict(config['model'], fcn_testing=True,
                     dtype=config['compute_dtype'])
    if quant:
        model_cfg['backbone'] = dict(model_cfg['backbone'], **quant)
    model = build_recognizer(model_cfg, train_cfg=None,
                             test_cfg=config.get('test_cfg'))
    model.to(device)
    model.load_state_dict(state, strict=True)
    return model


def device_norm(config: dict) -> dict:
    """The config's normalization, deferred to the device."""
    return dict(config['img_norm_cfg'], device=True)
