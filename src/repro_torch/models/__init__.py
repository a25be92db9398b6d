"""The LM substrate's models (hybrid family in this slice of the port).

  common.py       ModelConfig, norms, rope, dense layers
  attention.py    GQA attention (K3 on the full sequence), KV caches, decode
  ssm.py          Mamba2 mixer (K4 on the full sequence), recurrent step
  mlp.py          gated dense MLP
  transformer.py  hybrid blocks, the layer stack, embedding and logits
  convert.py      the reference's parameter tree -> the port's modules
"""
