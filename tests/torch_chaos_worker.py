"""A trainer process for the port's watchdog and chaos tests: a small
Llama fit over the packed pipeline under ``FitResilience`` with the
flight recorder on.

    python tests/torch_chaos_worker.py hang <dir> <device>
    python tests/torch_chaos_worker.py run <dir> <device> <steps> [<kill>]

``hang``: the watchdog (``step_timeout`` 3 s, action ``"kill"``) around
each step, and step 2 held for 60 s: the watchdog exits the process with
``RESUMABLE_EXIT_CODE`` and leaves its dump under ``<dir>/trace``.
``run``: restore from ``<dir>/ckpt`` if it holds a commit, then fit to
``<steps>`` global steps, saving every 2 (blocking saves); with
``<kill>``, the chaos harness SIGKILLs the process after fit step
``<kill>`` (once a job: its mark directory is ``<dir>/marks``). Prints
``step <global step> <loss>`` per step on stdout. ``<device>`` is
``cpu`` or ``cuda``."""
import os
import sys
import time

import torch

from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.data import DataPipeline
from paddle_tpu_torch.hapi import Callback, Model
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import flight_recorder, profile
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.resilience import FitResilience, chaos

from torch_io_samples import Docs


class Log(Callback):
    def __init__(self, fr, hold_at=None):
        self.fr, self.hold_at = fr, hold_at

    def on_train_batch_begin(self, step, logs=None):
        if step == self.hold_at:
            print(f"holding step {step}", flush=True)
            time.sleep(60)

    def on_train_batch_end(self, step, logs=None):
        print(f"step {self.fr.global_step} {logs['loss']!r}", flush=True)


def main(mode, work, device, steps=6, kill=None):
    torch.set_num_threads(1)
    profile.set_trace_dir(os.path.join(work, "trace"))
    flight_recorder.enable(capacity=256)
    net = LlamaForCausalLM(LlamaConfig.tiny(), device=device, seed=3)
    model = Model(net).prepare(
        AdamW(learning_rate=1e-3, parameters=net.parameters()), loss=None)
    pipe = DataPipeline(Docs(40, vocab=256), batch_size=2, seq_len=32,
                        pack=True, base_seed=1, drop_last=True)
    if mode == "hang":
        # the flash op's first call in a process (~2 s of PyTorch's
        # custom-op machinery) is paid before the deadlines
        with torch.no_grad():
            net(torch.ones(1, 8, dtype=torch.long, device=device))
        fr = FitResilience(checkpoint_dir=os.path.join(work, "ckpt"),
                           save_every_steps=100, pipeline=pipe,
                           step_timeout=3.0, watchdog_action="kill")
        model.fit(pipe, epochs=1, num_iters=3, verbose=0,
                  callbacks=[fr, Log(fr, hold_at=2)])
        return 0
    # blocking saves: the commit of step 2 lands before a kill at step 3
    fr = FitResilience(manager=CheckpointManager(
        os.path.join(work, "ckpt"), async_=False), save_every_steps=2,
        pipeline=pipe)
    done = fr.restore(model) or 0
    if kill is not None:
        chaos.configure(kill_at_step=kill,
                        mark_dir=os.path.join(work, "marks"))
    model.fit(pipe, epochs=10, num_iters=steps - done, verbose=0,
              callbacks=[fr, Log(fr)])
    return 0


if __name__ == "__main__":
    a = sys.argv[1:]
    sys.exit(main(a[0], a[1], a[2], *(int(v) for v in a[3:])))
