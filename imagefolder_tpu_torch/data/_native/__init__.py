from imagefolder_tpu_torch.data._native.fastops import (  # noqa: F401
    crop_flip_normalize,
    native_available,
)
