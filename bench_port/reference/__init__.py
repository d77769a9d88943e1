"""The plain reference that decides ``correct``: plain PyTorch and numpy,
float32 with TF32 off, importing nothing of the program under test.  One
forward module a model family (:mod:`.gcn`, :mod:`.hetero_gcn`), the
explanation around it (:mod:`.explain`) and a frozen copy of the draws
(:mod:`.prng`)."""
