"""The interruptBA hook of the port's ``SlamSystem``: the twin of
tests/test_scheduler.py::TestForcedHook. Lowered by default (every keyframe
event runs local BA), a forced value overrides it, and ``n_ba_interrupts``
counts the events whose local BA was skipped at its entry."""

import torch

from vo_slam_test_tpu_torch.config import SlamConfig
from vo_slam_test_tpu_torch.pipeline import system
from vo_slam_test_tpu_torch.slam_map.map_state import MapCaps

torch.set_num_threads(1)


def _sys():
    return system.SlamSystem(SlamConfig(), MapCaps(8, 256, 4, 64), device="cpu")


def test_default_is_false():
    s = _sys()
    assert s._force_interrupt_ba is None and s.n_ba_interrupts == 0
    assert not s._ba_interrupt()


def test_force_hook_overrides():
    s = _sys()
    s._force_interrupt_ba = True
    assert s._ba_interrupt()
    s._force_interrupt_ba = False
    assert not s._ba_interrupt()


def test_skipped_events_are_counted():
    s = _sys()
    s._fold_background([(0, True, system.BackgroundOut(ba_n1=5, ba_n2=3)),
                        (1, False, system.BackgroundOut()),
                        (2, True, system.BackgroundOut())])
    assert s.ba_iters == [(0, 5, 3), (2, 0, 0)] and s.n_ba_interrupts == 1
