"""The scope that keeps the port's float32 cuDNN convolutions out of TF32
(``core/device.float32_convs``), on the CPU.

cuDNN's TF32 flag is process-wide and the flow provider's thread convolves
while the stylizer does, so the scope counts entries across threads: inside
any entry the flag is off, and when the last thread leaves, the caller's
flag is back. (That the convolutions inside run in float32 on a card is
``tests/test_torch_kernels_gpu.py``'s TF32 tests.)
"""

import sys
import threading

import pytest
import torch

from fast_artistic_videos_tpu_torch.core import device as device_mod


@pytest.fixture
def tf32_on():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = saved


def test_scope_turns_tf32_off_and_restores_the_flag(tf32_on):
    with device_mod.float32_convs():
        assert torch.backends.cudnn.allow_tf32 is False
        with device_mod.float32_convs():
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is True
    with pytest.raises(RuntimeError):
        with device_mod.float32_convs():
            raise RuntimeError("a conv failed")
    assert torch.backends.cudnn.allow_tf32 is True


def test_scope_holds_across_threads(tf32_on):
    """Eight threads enter and leave the scope 2,000 times each with a short
    switch interval: no thread ever sees TF32 on inside the scope, and the
    flag is the caller's again at the end."""
    seen_on = []
    errors = []

    def work():
        try:
            for _ in range(2000):
                with device_mod.float32_convs():
                    if torch.backends.cudnn.allow_tf32:
                        seen_on.append(1)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    assert not seen_on
    assert torch.backends.cudnn.allow_tf32 is True
