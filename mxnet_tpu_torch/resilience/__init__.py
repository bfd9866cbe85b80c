"""Training resilience (counterpart of ``mxnet_tpu/resilience``): fault
injection, the non-finite guard, the step watchdog and the bounded retry.

Deterministic fault injection so every recovery path is exercised by real
failures (``faults``), the on-device non-finite guard with skip-step and
auto-rollback policies (``guard``), a heartbeat watchdog that dumps
all-thread stacks when a step wedges (``watchdog``) and the shared bounded
retry helper (``retry``); checkpointing, the durability half, is
``mxnet_tpu_torch.checkpoint``. The elastic controller, the autoscaler,
the stall verdict over a membership world and the drills wait for the
membership side channel (ROADMAP queue 1 item 10): ``ElasticController``,
``Autoscaler`` and ``stall_verdict`` raise and name it.

Arm faults with ``MXTPU_FAULT=site:kind[:prob[:seed[:first-last]]]``
(see ``faults.sites()`` for the registered sites).
"""
from __future__ import annotations

from ..base import MXNetError
from . import faults
from .faults import InjectedFault
from .guard import NonFiniteGuard
from .retry import retry_call
from .watchdog import StepWatchdog, format_all_stacks

__all__ = ['faults', 'InjectedFault', 'NonFiniteGuard', 'retry_call',
           'StepWatchdog', 'format_all_stacks', 'ElasticController',
           'Autoscaler', 'stall_verdict']


def _item10(name):
    def refuse(*args, **kwargs):
        raise MXNetError(
            f"resilience.{name}: the elastic runtime runs over the "
            f"membership side channel, which is not ported (ROADMAP queue "
            f"1 item 10)")
    refuse.__name__ = name
    return refuse


ElasticController = _item10('ElasticController')
Autoscaler = _item10('Autoscaler')
stall_verdict = _item10('stall_verdict')

# arm any sites named by the environment at import (the config var is
# read through the declared registry; an empty/unset var arms nothing)
faults.arm_from_env()
