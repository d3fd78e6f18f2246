from microbeseg_torch.utils.tiff import imread, imwrite  # noqa: F401
from microbeseg_torch.utils.image import (  # noqa: F401
    border_correction,
    get_nucleus_ids,
    min_max_normalization,
    pad_bucket_shape,
    unique_path,
    zero_pad_model_input,
)
