"""The prove's least NTT time (the trace INTT and the coset NTT,
``roofline.py``) over the device time of ntt_pass1 / ntt_pass2, in %."""

from benchmark import roofline
from benchmark.readers import roofline_share


def read(run: dict):
    return roofline_share(run, ("ntt_pass",), roofline.ntt_least_s)
