"""The plain PyTorch decoder against K5, the JAX package's Pallas gather
kernel with messages streamed through HBM (``_build_streamed_chunked_kernel``,
``io_mode="stream"``), in interpret mode on the CPU: bit-exact in bits and
``iters_used``.  The case is that of ``test_torch_gather_pallas.py``, in a
file of its own so that the slow interpret runs spread over two workers.
"""

from test_torch_gather_pallas import (  # noqa: F401 (a fixture)
    _one_torch_thread,
    check_against_pallas,
)


def test_plain_matches_pallas_gather_stream_interpret():
    check_against_pallas(chunked=True, io_mode="stream", sublanes=4)
