"""Plain PyTorch reference of the benchmark's model.

Written from the published wekws model definitions (the DS-TCN, the
linear preprocessing, the wake-word head and its max-pooling loss) and
Kaldi's feature definition.  It imports no module of the measured
package and takes nothing it made: the weights and inputs come from the
harness, and every derived quantity (mel banks, DCT, the per-step
dither draws) is worked out here again.

``precision`` selects the arithmetic of the model's products:

- ``"fp32"``: float32 with TF32 off (the reference);
- ``"tf32"``: TF32 products (the control of a float32 configuration).
"""
