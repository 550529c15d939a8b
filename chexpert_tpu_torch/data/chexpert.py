"""CheXpert label names and pixel statistics (copy of the JAX package's
``data/chexpert.py`` constants; that module cannot be imported without JAX).
"""

# competition labels, in the model's output order
ATTR_NAMES = ["Atelectasis", "Cardiomegaly", "Consolidation", "Edema", "Pleural Effusion"]

# dataset pixel statistics used to whiten [0, 1] images
PIXEL_MEAN = 0.5330
PIXEL_STD = 0.0349
