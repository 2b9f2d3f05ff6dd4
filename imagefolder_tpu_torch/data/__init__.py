from imagefolder_tpu_torch.data.builders import (
    CodeSource,
    JsonPathsSource,
    SingleFolderSource,
    Text2ImgImageSource,
    Text2ImgSource,
    build_dataset,
    make_loader,
)
from imagefolder_tpu_torch.data.imagenet import (
    ImageFolderSource,
    center_crop_arr,
    device_prefetch,
    list_image_folder,
    make_dataloader,
    random_crop_arr,
)

__all__ = [
    "ImageFolderSource", "center_crop_arr", "device_prefetch",
    "list_image_folder", "make_dataloader", "random_crop_arr",
    "build_dataset", "make_loader", "SingleFolderSource", "JsonPathsSource",
    "CodeSource", "Text2ImgImageSource", "Text2ImgSource",
]
