"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package (``paddle_tpu``) stays the reference; this package
mirrors it path for path, written in PyTorch for one NVIDIA H100. Every
Pallas kernel on a ported path becomes a kernel written by hand for
Hopper (``ops/pallas/csrc/``), built with ``nvcc`` at first use and
bound through ``ctypes``; everything around the kernels is plain
PyTorch. The package never imports ``jax`` or ``paddle_tpu``.

Drive it as Paddle::

    import paddle_tpu_torch as paddle
    x = paddle.to_tensor([[1.0, 2.0]], stop_gradient=False)
    y = paddle.matmul(x, x.transpose([1, 0])).sum()
    y.backward()

Everything runs on the card unless the caller asks for the CPU
(``paddle.set_device("cpu")``, or ``device="cpu"`` at an entry point);
asking for the card where there is none raises. On a CPU tensor a kernel
wrapper computes its plain PyTorch version, which is how the CPU tests
hold the port against the reference.

The top level exports what the reference's does for every subsystem the
port has: the dtypes, ``Tensor``/``Parameter``/``to_tensor`` (a facade
over ``torch.Tensor`` that lives only at the user API,
``core/tensor.py``), the autograd API, the flags, every op of the op
library (``ops``), ``nn`` (every layer an ``nn.Layer``), ``optimizer``,
``jit`` (``to_static`` over CUDA-graph capture, the functional trio,
``TrainStep``, ``save``/``load`` over ``torch.export``), ``amp`` (``auto_cast``, ``decorate``, ``GradScaler``),
``io``, ``save``/``load``, ``Model``,
``ParamAttr``, ``metric``, ``vision``, ``serving``, ``checkpoint``,
``data``, ``quantization`` (QAT, PTQ, real int8 layers and the serving
engine's weight-only PTQ), ``tuning`` (LoRA), ``incubate`` (the fused
layers, LookAhead/ModelAverage/EMA, auto-checkpoint, functional autodiff,
ASP), ``static`` (``InputSpec``, and the Program/Executor workflow
over a recorded program), ``inference`` (``Config``/``Predictor`` over
``jit.save``'s ``torch.export`` program), ``profiler`` (host spans,
the device capture, the chrome export), ``models`` and the device
functions. The models: Llama-3
(serving, training and eager ``generate``), the MoE family (the same),
ERNIE, DiT and PP-OCRv4. A subsystem that is not ported (``sparse``,
``audio``, ...) is not exported: reaching it raises ``AttributeError``.
"""
from __future__ import annotations

__version__ = "0.1.0"

from paddle_tpu_torch.core.dtype import (  # noqa: F401
    DType, bfloat16, bool_, complex64, complex128, finfo, float16, float32,
    float64, iinfo, int8, int16, int32, int64, uint8,
)
from paddle_tpu_torch.core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from paddle_tpu_torch.core.autograd import (  # noqa: F401
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
)
from paddle_tpu_torch.core.generator import (  # noqa: F401
    Generator, get_rng_state, seed, set_rng_state,
)
from paddle_tpu_torch.core.flags import get_flags, set_flags  # noqa: F401

from paddle_tpu_torch import ops  # noqa: F401  (installs Tensor methods)
from paddle_tpu_torch.ops import *  # noqa: F401,F403

from paddle_tpu_torch import nn  # noqa: F401
from paddle_tpu_torch import optimizer  # noqa: F401
from paddle_tpu_torch import autograd  # noqa: F401
from paddle_tpu_torch import regularizer  # noqa: F401
from paddle_tpu_torch import jit  # noqa: F401
from paddle_tpu_torch import amp  # noqa: F401
from paddle_tpu_torch import distributed  # noqa: F401
from paddle_tpu_torch import io  # noqa: F401
from paddle_tpu_torch import framework  # noqa: F401
from paddle_tpu_torch.framework.io import load, save  # noqa: F401
from paddle_tpu_torch import metric  # noqa: F401
from paddle_tpu_torch import hapi  # noqa: F401
from paddle_tpu_torch.hapi import Model  # noqa: F401
from paddle_tpu_torch import observability  # noqa: F401
from paddle_tpu_torch import resilience  # noqa: F401
from paddle_tpu_torch import vision  # noqa: F401
from paddle_tpu_torch import quantization  # noqa: F401
from paddle_tpu_torch import tuning  # noqa: F401
from paddle_tpu_torch import incubate  # noqa: F401
from paddle_tpu_torch import serving  # noqa: F401
from paddle_tpu_torch import checkpoint  # noqa: F401
from paddle_tpu_torch import data  # noqa: F401
from paddle_tpu_torch import utils  # noqa: F401
from paddle_tpu_torch import models  # noqa: F401
from paddle_tpu_torch.param_attr import ParamAttr  # noqa: F401
from paddle_tpu_torch import device  # noqa: F401
from paddle_tpu_torch.device import (  # noqa: F401
    device_count, get_device, is_compiled_with_cuda, is_compiled_with_xpu,
    set_device,
)
from paddle_tpu_torch import callbacks  # noqa: F401
from paddle_tpu_torch.batch import batch  # noqa: F401
from paddle_tpu_torch import linalg  # noqa: F401
from paddle_tpu_torch import static  # noqa: F401
from paddle_tpu_torch import inference  # noqa: F401
from paddle_tpu_torch import profiler  # noqa: F401

bool = bool_  # paddle.bool


def is_compiled_with_tpu() -> bool:
    return False


def summary(net, input_size=None, dtypes=None, input=None):
    """``paddle.summary``: the layer tree and its parameter counts
    (``input`` may stand in for ``input_size``; the count does not depend
    on either)."""
    if input_size is None and input is not None:
        input_size = tuple(input.shape)
    return Model(net).summary(input_size)


def flops(net, input_size, custom_ops=None, print_detail: bool = False):
    """``paddle.flops``: the forward's floating-point operations on a zero
    input of ``input_size``, counted by PyTorch's
    ``torch.utils.flop_counter.FlopCounterMode`` (where the reference asks
    XLA's cost analysis)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    p = next(iter(net.parameters()), None)
    dev = p.device if p is not None else device.resolve_device(None)
    x = torch.zeros(tuple(input_size), device=dev)
    counter = FlopCounterMode(display=print_detail)
    with torch.no_grad(), counter:
        net(x)
    return int(counter.get_total_flops())


_mode = {"dynamic": True}


def enable_static():
    """Enter the static-graph workflow (reference ``enable_static``).

    Ops still run at once, on ``static.data``'s placeholders; inside a
    ``static.program_guard`` they are recorded, and
    ``static.Executor.run`` replays the record (``static/graph.py``).
    ``Optimizer.minimize`` attaches itself to the program instead of
    stepping."""
    _mode["dynamic"] = False


def disable_static():
    _mode["dynamic"] = True


def in_dynamic_mode() -> bool:
    return _mode["dynamic"]
