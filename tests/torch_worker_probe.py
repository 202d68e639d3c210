"""A MultiprocessLoader factory for the tests: the port's train egs, each
batch tagged with what its worker process saw (its pid, its
CUDA_VISIBLE_DEVICES, whether torch was imported, and, where it was,
whether CUDA was initialised and whether the worker would see a card).
Module-level, so spawn workers can import it."""

import os
import sys


class _Tagged:
    def __init__(self, egs):
        self.egs = egs

    def set_epoch(self, epoch):
        self.egs.set_epoch(epoch)

    def __iter__(self):
        for batch in self.egs:
            torch = sys.modules.get("torch")
            yield dict(batch, pid=os.getpid(), cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
                       torch_imported=torch is not None,
                       cuda_initialized=bool(torch is not None and torch.cuda.is_initialized()),
                       cuda_available=bool(torch is not None and torch.cuda.is_available()))


def probe_egs(cfg, worker_id=0, num_workers=1, probe=False):
    from asv_subtools_tpu_torch.data.dataset import _build_train_egs

    return _Tagged(_build_train_egs(cfg, worker_id=worker_id, num_workers=num_workers, probe=probe))
