"""Dataset pixel statistics (the JAX package's ``data/stats.py``):
Cityscapes BGR pixel means/vars in [0,255] space. The ImageNet
normalization constants of the active path live in ``train/assemble.py``.
"""

import numpy as np

CITYSCAPE_PIXEL_MEANS = np.array([73.15835921, 82.90891754, 72.39239876])
CITYSCAPE_PIXEL_VARS = np.array([[[73.15835921, 82.90891754, 72.39239876]]])
