"""PyTorch / CUDA port of video_learning_tpu for NVIDIA Hopper GPUs.

The JAX package (``video_learning_tpu``) is the reference; this package
imports neither it nor JAX.  Ported so far: the flagship serving path
(device preprocessing, AlexNet to fc7 with the LRN CUDA kernel, the
2x256 LSTM with the lstm_step CUDA kernel, the serving module and the
HTTP micro-batcher), the training step with its backward kernels, the
captioning path, int8 serving, the run config with the read side of the
data layer, the run driver with evaluation and checkpoints, and the
path from media to answer: offline packing (``data/serialize.py``,
``data/samplers.py``), caption preprocessing and the packed-data tools
(``tools/process_annotations.py``, ``produce_vocab_embeddings.py``,
``caption_vocab_tools.py``, ``check_serialized_data.py``,
``compute_image_mean.py``), inference on raw media (``tools/infer.py``)
and export from a checkpoint (``tools/export_serving.py``), and on the
card every program (the training step, ``Train.compile_scan_steps``, the
evaluation and serving forward, the caption decodes) as a CUDA graph
replay (``graphs.py``), and the (data x model) mesh of
``torch.distributed`` ranks for training, evaluation, the run driver and
export (``parallel/``).
"""
