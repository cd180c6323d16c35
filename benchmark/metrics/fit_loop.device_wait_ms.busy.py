"""fit_loop.device_wait_ms.busy: the reading of ``fit_loop.device_wait_ms.py``, in the cells whose
end-to-end metric is the device's busy time per step
(``fit_device_ms_per_step``), which it moves there."""

from pathlib import Path

from benchmark import core

_base = core.load_module(Path(__file__).with_name("fit_loop.device_wait_ms.py"))
SPANS, read = _base.SPANS, _base.read
