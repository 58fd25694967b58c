"""The plain float32 LRCN that decides a run's ``correct``.

Plain PyTorch only: it imports nothing of the program under test and
takes nothing the program made.  ``lrcn.py`` holds the model, the loss
and the clipped SGD step.
"""
