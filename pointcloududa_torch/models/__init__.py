"""``nn.Module`` twins of the JAX package's models.

- :mod:`unet`          — the segmentation generator (encoder / dilated
                         bottleneck / point-cloud head / decoder).
- :mod:`discriminator` — PatchGAN discriminators for output space (D1) and
                         entropy-map space (D2).
- :mod:`pointnet`      — PointNet binary classifier over point clouds (D4).

Public forwards take the JAX package's layouts (NHWC images, (B, N, 3)
clouds); module names follow the reference's ``state_dict`` keys.
"""

from pointcloududa_torch.models.discriminator import UncertaintyDiscriminator  # noqa: F401
from pointcloududa_torch.models.pointnet import PointNetCls, feature_transform_regularizer  # noqa: F401
from pointcloududa_torch.models.unet import SegmentationPointModel  # noqa: F401
