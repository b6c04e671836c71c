"""unet_device_ms.convert: device ms per chunk of the UNets' kernels in the
traced window, by name: convolutions, cuDNN's layout transposes, the
bilinear upsample, average pooling, LeakyReLU and concatenation."""
from portbench.readers import traced_chunks

UNET_PATTERNS = ("conv", "cudnn", "xmma", "gemm", "implicit", "winograd", "cutlass", "sm90",
                 "nchwtonhwc", "nhwctonchw", "upsample_bilinear", "avg_pool", "leaky_relu",
                 "catarraybatchedcopy")


def read(run):
    n = traced_chunks(run)
    if not n:
        return None
    t = sum(e - s for s, e, name in run.trace_data.kernels()
            if any(p in name.lower() for p in UNET_PATTERNS))
    return t / 1e6 / n if t else None
