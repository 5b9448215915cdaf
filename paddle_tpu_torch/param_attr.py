"""``ParamAttr`` — port of ``paddle_tpu/param_attr.py``, with the
parameter factory of the reference's ``Layer.create_parameter``
(``paddle_tpu/nn/layer_base.py:44``).

``weight_attr``/``bias_attr`` take Paddle's union: ``None`` (the
default initializer), ``False`` (no parameter), an initializer, a name
or a :class:`ParamAttr`.
"""
from __future__ import annotations

import torch

__all__ = ["ParamAttr", "create_parameter"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> None (the default), False -> False (no parameter), an
        initializer -> ``ParamAttr(initializer=...)``, a str -> a name."""
        if attr is None or isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


def create_parameter(shape, *, device, dtype, attr=None, is_bias=False,
                     default_initializer=None) -> torch.nn.Parameter:
    """A parameter of ``shape`` on ``device``: ``attr``'s initializer,
    else ``default_initializer``, else Paddle's default (zeros for a
    bias, Xavier-uniform for a weight). ``trainable=False`` gives a
    parameter that needs no gradient."""
    from paddle_tpu_torch.nn import initializer as I
    attr = ParamAttr._to_attr(attr)
    init = default_initializer
    if attr is not None and getattr(attr, "initializer", None) is not None:
        init = attr.initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierUniform()
    trainable = attr is None or getattr(attr, "trainable", True) is not False
    return torch.nn.Parameter(init(list(shape), dtype, device),
                              requires_grad=trainable)
