"""conv_ms.train: device milliseconds a call in the convolution kernels of
AlexNet (cuDNN's forward, data-gradient and weight-gradient kernels and
the layout transforms they run around grouped convolutions); the port's
own conv1 weight-gradient kernel is not counted here."""

# cuDNN / CUTLASS convolution kernels, by the names they carry on Hopper
PATTERN = (r"(?i)^(?!.*conv1_dw)(.*(fprop|dgrad|wgrad|implicit_convolve|"
           r"implicit_gemm|convolution|conv2d|tensorTransformGeneric|"
           r"nhwcSliceCKernel|nhwcAddPaddingKernel|nchwToNhwc|nhwcToNchw))")


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return run.trace.device_ms_per_call(PATTERN)
