"""Host ms of infer.decode a scene: the copy of the head outputs to the
host, the decode and the NMS (the card synchronized first, so the forward
is not in it)."""
from benchmark.readers import host_ms

WRAPS = ("sgcdet_tpu_torch.infer:decode",)


def read(trace):
    return host_ms(trace, WRAPS[0])
