"""The plain reference of what the benchmark's cells run: the R2D2
network's forward pass for both torsos, the loss and priorities, Adam with
global-norm clipping, the prioritized draw and the sequence gather.  Plain
PyTorch in float32 with TF32 off, or in emulated fp8 for the control.  It
imports nothing of the port and takes nothing the port made: its weights
are the benchmark's own (``gpu_bench/weights.py``), and the port's outputs
are read only to be judged."""
