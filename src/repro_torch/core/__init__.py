"""The paper's primary contribution: mixed-kernel mixed-signal SVMs (port).

Layout:
  kernels.py    linear / RBF / hardware-sech2 kernel math (Eqs. 2-6)
  svm.py        dual-coordinate-ascent SVM over solver lanes + CV grid
  analog.py     circuit surrogate + behavioral model (Sec. IV-A), nominal
  quant.py      ADC / fixed-point quantization (Sec. V-A2)
  ovo.py        OvO decomposition, encoder decision logic, digital datapaths
  trainer.py    batched Algorithm-1 engine
  selection.py  Algorithm 1 entry point + Table-II banks
  hwcost.py     FlexIC area/power cost model
"""
