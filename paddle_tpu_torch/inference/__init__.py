"""``paddle.inference`` — port of ``paddle_tpu/inference/__init__.py``.

``Config`` names a ``jit.save`` program, ``Predictor`` loads it
(``jit.serialization.load_program``) and runs it behind the reference's
handle API: ``run([arrays])``, or ``get_input_handle(name)
.copy_from_cpu(array)``, ``run()``, ``get_output_handle(name)
.copy_to_cpu()``. The predictor runs on the card unless
``Config.disable_gpu()`` is called (or ``set_device("cpu")`` chose the
CPU for the process); a program exported on the other device is moved
with ``torch.export``'s ``move_to_device_pass``. A program holding the
flash-attention forward runs it as the registered op
``paddle_tpu::flash_fwd``, which launches K1 on the card.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

__all__ = ["Config", "create_predictor", "Predictor", "Tensor",
           "PrecisionType", "PlaceType"]


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1


class Config:
    """``paddle.inference.Config``: the program's path and where it
    runs (reference ``api/paddle_analysis_config.h``, the subset the
    reference keeps)."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._device = None  # the default device: the card
        self.set_model(prog_file, params_file)
        self._enable_memory_optim = True
        self._switch_ir_optim = True

    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        """Only the model paths change; the options stay (reference
        ``AnalysisConfig::SetModel``)."""
        if prog_file is not None and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self._model_dir = prog_file
        self._params_file = params_file

    def model_dir(self):
        return self._model_dir

    def enable_memory_optim(self, flag: bool = True):
        self._enable_memory_optim = flag

    def switch_ir_optim(self, flag: bool = True):
        self._switch_ir_optim = flag

    def enable_xpu(self, *a, **k):
        """The reference's accelerator switch: the card."""
        self._device = "cuda"

    def disable_gpu(self):
        self._device = "cpu"

    def summary(self) -> str:
        return (f"Config(model={self._model_dir}, "
                f"device={self._device or 'default'}, "
                f"memory_optim={self._enable_memory_optim})")


class Tensor:
    """A predictor's input or output handle (reference
    ``paddle_infer::Tensor``)."""

    def __init__(self, name: str, owner: "Predictor", is_input: bool):
        self.name = name
        self._owner = owner
        self._is_input = is_input

    def copy_from_cpu(self, arr: np.ndarray):
        if not self._is_input:
            raise ValueError("copy_from_cpu on an output handle")
        self._owner._feed[self.name] = np.ascontiguousarray(arr)

    def reshape(self, shape):
        pass  # the fed array carries its shape

    def copy_to_cpu(self) -> np.ndarray:
        if self._is_input:
            raise ValueError("copy_to_cpu on an input handle")
        return _to_numpy(self._owner._fetch[self.name])

    def shape(self):
        if self._is_input:
            a = self._owner._feed.get(self.name)
            return list(a.shape) if a is not None else None
        return list(self._owner._fetch[self.name].shape)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()  # numpy has no bfloat16
    return t.cpu().numpy()


class Predictor:
    """Runs a ``jit.save`` program (reference ``AnalysisPredictor::Run``)."""

    def __init__(self, config: Config):
        from paddle_tpu_torch.jit.serialization import load_program
        from torch.export.graph_signature import InputKind

        self._config = config
        path = config.model_dir()
        if path is None or not os.path.exists(path + ".pdmodel"):
            raise FileNotFoundError(
                f"no inference model at {path}.pdmodel; export one with "
                "paddle_tpu_torch.jit.save(layer, path, input_spec=...)")
        program, self._device = load_program(path, config._device)
        self._module = program.module()
        n_in = sum(s.kind == InputKind.USER_INPUT
                   for s in program.graph_signature.input_specs)
        self._input_names = [f"x{i}" for i in range(n_in)]
        self._feed = {}
        self._fetch = {}
        self._output_names: List[str] = []

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> Tensor:
        return Tensor(name, self, is_input=True)

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_output_handle(self, name: str) -> Tensor:
        return Tensor(name, self, is_input=False)

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Run the program: on ``inputs`` given positionally
        (``predictor.run([x])``), or on what the input handles hold.
        Returns the outputs as numpy arrays."""
        if inputs is not None:
            if len(inputs) != len(self._input_names):
                raise ValueError(
                    f"model expects {len(self._input_names)} inputs, got "
                    f"{len(inputs)}")
            for name, arr in zip(self._input_names, inputs):
                self._feed[name] = np.ascontiguousarray(arr)
        missing = [n for n in self._input_names if n not in self._feed]
        if missing:
            raise RuntimeError(f"inputs not set: {missing}")
        args = [torch.from_numpy(self._feed[n]).to(self._device)
                for n in self._input_names]
        with torch.no_grad():
            out = self._module(*args)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        self._output_names = [f"out{i}" for i in range(len(outs))]
        self._fetch = dict(zip(self._output_names, outs))
        return [_to_numpy(o) for o in outs]

    def try_shrink_memory(self):
        pass

    def clear_intermediate_tensor(self):
        self._feed.clear()
        self._fetch.clear()


def create_predictor(config: Config) -> Predictor:
    """``paddle.inference.create_predictor``."""
    return Predictor(config)
