"""A trainer process for the port's preemption test: a tiny Llama fit
over the packed pipeline under ``FitResilience`` that sends itself
SIGUSR1 after step ``KILL_AT`` and exits with ``exit_if_preempted``.

    python tests/torch_resilience_worker.py <checkpoint dir> <KILL_AT>

Prints one line per trained step (``step <n> <loss>``) on stdout."""
import os
import signal
import sys

import torch

from paddle_tpu_torch.data import DataPipeline
from paddle_tpu_torch.hapi import Callback, Model
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.resilience import FitResilience

from torch_io_samples import Docs


class SelfSignal(Callback):
    def __init__(self, at):
        self.at = at

    def on_train_batch_end(self, step, logs=None):
        print(f"step {step} {logs['loss']!r}", flush=True)
        if step == self.at:
            os.kill(os.getpid(), signal.SIGUSR1)


def main(ckpt_dir, kill_at):
    torch.set_num_threads(1)
    net = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
    model = Model(net).prepare(
        AdamW(learning_rate=1e-3, parameters=net.parameters()), loss=None)
    pipe = DataPipeline(Docs(40, vocab=256), batch_size=2, seq_len=32,
                        pack=True, base_seed=1, drop_last=True)
    fr = FitResilience(checkpoint_dir=ckpt_dir, save_every_steps=100,
                       pipeline=pipe)
    fr.restore(model)
    model.fit(pipe, epochs=3, verbose=0,
              callbacks=[SelfSignal(kill_at), fr])
    fr.exit_if_preempted()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
