"""The repo's ``scripts/`` tools on the port, one module of the same name
each (``python -m megaportraits_tpu_torch.scripts.<name>``): the same
flags, defaults and console lines, on the card unless given ``--device
cpu``. ``scripts/convert_weights.py`` is served by
``utils/convert_weights.py``."""
