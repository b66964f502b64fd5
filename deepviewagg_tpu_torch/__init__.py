"""deepviewagg_tpu_torch — the PyTorch / CUDA port of deepviewagg_tpu.

Runs the flagship multimodal forward (Res16UNet34 + an early-fused
ResNet18-PPM image branch with group-attention view pooling) and its
splatting-visibility preprocessing on an NVIDIA Hopper card.  The sorted
segment reductions of the pooling stages run in the hand-written CUDA
kernel ``csrc/segment_csr.cu``.  The package imports nothing of JAX or of
``deepviewagg_tpu``; entry points take ``device="cuda"`` unless told
otherwise.
"""
