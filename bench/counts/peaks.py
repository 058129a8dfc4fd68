"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates without
sparsity, at the 700 W limit), as ``launch/roofline.py`` and
``chip_smoke.py`` of the port state them."""

#: dot FLOP/s by the precision a product computes in
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
}
#: HBM3 bytes/s
HBM_BW = 3.35e12
#: special function units (exp2) per SM per clock, SMs, maximum SM clock
SFU_PER_SM_CLK = 16
SMS = 132
MAX_SM_CLOCK_HZ = 1980e6


def peak_flops(precision: str) -> float:
    """The dot peak of ``precision`` (a key of :data:`PEAK_FLOPS`)."""
    try:
        return PEAK_FLOPS[precision]
    except KeyError:
        raise ValueError(f"no peak for precision {precision!r}; have "
                         f"{sorted(PEAK_FLOPS)}") from None
