"""The LM substrate's models, every family of the reference.

  common.py       ModelConfig, norms, rope, dense layers
  attention.py    GQA attention (K3 on the full sequence), KV caches, decode
  ssm.py          Mamba2 mixer (K4 on the full sequence), recurrent step
  mlp.py          gated dense MLP and the sort-based capacity MoE
  transformer.py  blocks of each family, the layer stack, the whisper
                  encoder / decoder, embedding and logits
  convert.py      the reference's parameter tree -> the port's modules
"""
