"""nn of the PyTorch port (see deepviewagg_tpu_torch/__init__.py): norms,
sparse-conv blocks, the Res16UNet family and the point backbones, as the
JAX package's ``nn/__init__.py`` imports them (``pointnet`` and ``ppnet``
import on their own there and here)."""

from . import norm  # noqa: F401
from . import sparse_blocks  # noqa: F401
from . import res16unet  # noqa: F401
from . import pointnet2  # noqa: F401
from . import kpconv  # noqa: F401
from . import randlanet  # noqa: F401
from . import rsconv  # noqa: F401
from . import pvcnn  # noqa: F401
from . import pointcnn  # noqa: F401
