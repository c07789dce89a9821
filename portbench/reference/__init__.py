"""The plain reference that decides ``correct``: PyTorch operations only,
in fp32 (or, for the control, with every product's operands rounded to
TF32), written from the published model.  It imports nothing of the port
and takes nothing the program made: the weights and tokens are
regenerated from the seed by ``portbench.lib``.  ``model.py`` is the Llama
form's (``families/llama.py`` names it as its family's); ``train.py``
follows any family's ``loss`` through the first training steps."""
