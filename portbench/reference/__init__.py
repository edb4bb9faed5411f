"""The plain reference: float32 PyTorch with TF32 off, written from the
published descriptions and frozen here. It imports nothing of the program
and takes nothing the program made: it works the encoding, the samples, the
marked cells and the thresholds out again from the benchmark's inputs.

``prec="fp8"`` is the control: every matmul operand (the encoding, the
activations, the weights) and the fields' outputs rounded to float8 e4m3
with a per-tensor scale, the step below the configuration's bf16."""
