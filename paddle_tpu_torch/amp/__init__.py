"""Automatic mixed precision — port of ``paddle_tpu/amp/``.

``auto_cast`` installs a thread-local policy that the port consults by
op name, as the reference's ``core.autograd.apply_op`` does
(``paddle_tpu/core/autograd.py:228-250``): the op library's dispatch
(``ops/_registry.dispatch``), every ``nn.functional`` function, and the
few port functions that compute a listed op with torch directly (the
Llama logits product). White-list ops (matmul, convolution, linear,
attention) cast their floating inputs to the low dtype; black-list ops
(softmax, the norms, the losses, exp/log, reductions) to float32; any
other op keeps its inputs under O1 and casts them to the low dtype under
O2. PyTorch's ``torch.autocast`` is not used: its op lists are not
Paddle's, and the dtypes would differ from the reference's.

``GradScaler`` is dynamic loss scaling for float16, with one found-inf
flag kept on the card and read once a step.
"""
from .auto_cast import (  # noqa: F401
    amp_guard, amp_state, auto_cast, black_list, decorate,
    is_bfloat16_supported, is_float16_supported, white_list,
)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "AmpScaler",
           "is_bfloat16_supported", "is_float16_supported"]
