"""``auto_cast`` — port of ``paddle_tpu/amp/auto_cast.py``.

The lists are the reference's, name for name (:15-30). :func:`cast_inputs`
and :func:`cast_for` are what the port's op sites call with their op
name; with no policy active they cost one read of a module-level count.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Set

import torch

__all__ = ["auto_cast", "amp_guard", "amp_state", "decorate", "white_list",
           "is_bfloat16_supported", "is_float16_supported", "black_list",
           "cast_inputs", "cast_for"]

_tls = threading.local()
#: enabled auto_cast contexts open on any thread: the op sites' fast test
_open = [0]

# the reference's O1 lists: white = the tensor-core ops that take low
# precision well; black = numerically fragile ops pinned to float32
WHITE_LIST = {
    "matmul", "mm", "bmm", "conv1d", "conv2d", "conv3d", "conv_nd",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "linear",
    "einsum", "addmm", "mv", "flash_attention",
    "scaled_dot_product_attention",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "kl_div", "ctc_loss", "layer_norm", "rms_norm", "batch_norm",
    "instance_norm", "group_norm", "local_response_norm", "mean", "sum",
    "cumsum", "prod", "norm", "cosine_similarity", "erf", "erfinv",
    "sigmoid_focal_loss", "smooth_l1_loss", "mse_loss", "l1_loss", "dist",
    "logsumexp", "softplus",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def white_list() -> Set[str]:
    return set(WHITE_LIST)


def black_list() -> Set[str]:
    return set(BLACK_LIST)


class _AmpState:
    __slots__ = ("enable", "dtype", "level", "white", "black")

    def __init__(self, enable, dtype, level, white, black):
        self.enable = enable
        self.dtype = dtype
        self.level = level
        self.white = white
        self.black = black


def amp_state() -> Optional[_AmpState]:
    return getattr(_tls, "amp", None)


def _policy_dtype(state: _AmpState, op_name: str):
    """The op's target dtype name under the policy, or None (keep)."""
    name = (op_name or "").lower()
    if name in state.black:
        return "float32"
    if name in state.white:
        return state.dtype
    if state.level == "O2":
        return state.dtype
    return None  # O1: an op on neither list runs in its inputs' dtype


def _target(op_name):
    state = amp_state()
    if state is None:
        return None
    target = _policy_dtype(state, op_name)
    return None if target is None else _DTYPES[target]


def _cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() and x.dtype != dtype \
            else x
    if isinstance(x, (list, tuple)) and any(
            isinstance(v, torch.Tensor) for v in x):
        return type(x)(_cast(v, dtype) for v in x)
    return x


def cast_inputs(op_name, args, kwargs):
    """``(args, kwargs)`` with every floating tensor (also inside a list
    or tuple argument) cast to ``op_name``'s dtype under the active
    policy; unchanged with none."""
    if not _open[0]:
        return args, kwargs
    dtype = _target(op_name)
    if dtype is None:
        return args, kwargs
    return (tuple(_cast(a, dtype) for a in args),
            {k: _cast(v, dtype) for k, v in kwargs.items()})


def cast_for(op_name, *tensors):
    """The tensors cast as :func:`cast_inputs` casts an op's inputs."""
    if not _open[0]:
        return tensors
    dtype = _target(op_name)
    return tensors if dtype is None else tuple(_cast(t, dtype)
                                               for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """``paddle.amp.auto_cast`` (reference :296): levels O0 (off), O1,
    O2 and OD; ``custom_white_list`` moves names to the white list (off
    the black one), ``custom_black_list`` the other way, applied in that
    order. Contexts nest; the inner one holds until it exits."""
    if level not in ("O0", "O1", "O2", "OD"):
        raise ValueError(f"unsupported amp level {level!r}")
    if dtype not in ("bfloat16", "float16"):
        raise ValueError(f"unsupported amp dtype {dtype!r}")
    white = set(WHITE_LIST)
    black = set(BLACK_LIST)
    if custom_white_list:
        white |= {str(n).lower() for n in custom_white_list}
        black -= white
    if custom_black_list:
        black |= {str(n).lower() for n in custom_black_list}
        white -= black
    on = bool(enable) and level != "O0"
    prev = amp_state()
    _tls.amp = _AmpState(True, dtype, level, white, black) if on else None
    _open[0] += on
    try:
        yield
    finally:
        _open[0] -= on
        _tls.amp = prev


amp_guard = auto_cast  # the legacy name (fluid.dygraph.amp.amp_guard)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: O2 casts every floating parameter of the
    models to ``dtype`` in place; the optimizers keep f32 master weights
    (``_multi_precision``) under O2 or with ``master_weight=True``."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        low = _DTYPES[dtype]
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point() and p.dtype != low:
                        p.data = p.data.to(low)
    if optimizers is None:
        return model_list[0] if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    if master_weight or (master_weight is None and level == "O2"):
        for o in opt_list:
            o._multi_precision = True
    return (model_list[0] if single_model else model_list,
            opt_list[0] if single_opt else opt_list)


def _device(device):
    from paddle_tpu_torch.device import resolve_device
    return resolve_device(device)


def is_bfloat16_supported(device=None) -> bool:
    """Whether the device computes in bfloat16: the card's answer
    (``torch.cuda.is_bf16_supported``); PyTorch's CPU kernels take it."""
    dev = _device(device)
    if dev.type == "cpu":
        return True
    with torch.cuda.device(dev):
        return torch.cuda.is_bf16_supported()


def is_float16_supported(device=None) -> bool:
    """Whether the device computes in float16: on the card, compute
    capability 5.3 or later; PyTorch's CPU kernels take it."""
    dev = _device(device)
    if dev.type == "cpu":
        return True
    return torch.cuda.get_device_capability(dev) >= (5, 3)
