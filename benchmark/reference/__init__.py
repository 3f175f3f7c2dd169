"""The frozen plain reference: the port's eager step as plain PyTorch and
its numpy mesh, coefficient and initial-condition code, copied here so
that later changes to the program cannot move the yardstick. It carries
what the benchmark's configurations run (one device, the stencil form, the
default edge numbering, JW with WSM6 and the PBL) and refuses any other
option (`dynamics.model.SUPPORTED`). It imports torch, numpy and scipy,
nothing of the program."""
