"""One torch thread for a test module's CPU work.

The tier-1 command runs six pytest workers on the machine's cores, each
with torch's default intra-op pool of one thread per core: a port test's
many small CPU ops then wait on oversubscribed threads (six copies of
``test_torch_train.py``'s 40-step training test took 450 s each at the
default, 4.5 s at one thread). Modules that train or encode on the CPU use
``one_torch_thread``; it restores the count after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
