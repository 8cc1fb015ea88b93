"""Published peaks of the cards the benchmark knows, by the name that
`torch.cuda.get_device_name()` gives: dense float rates outside the tensor
cores and HBM bandwidth (NVIDIA H100 SXM data sheet, at its 700 W limit;
the power limit a run found is printed beside every share of them)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "float64": 34e12, "bytes_per_s": 3.35e12},
}
