"""PyTorch / CUDA port of video_learning_tpu for NVIDIA Hopper GPUs.

The JAX package (``video_learning_tpu``) is the reference; this package
imports neither it nor JAX.  Ported so far: the flagship serving path
(device preprocessing, AlexNet to fc7 with the LRN CUDA kernel, the
2x256 LSTM with the lstm_step CUDA kernel, the serving module and the
HTTP micro-batcher), the training step with its backward kernels, the
captioning path, int8 serving, and the run config with the read side of
the data layer that feeds the training step.
"""
