from microbeseg_torch.client.contours import (  # noqa: F401
    get_indices_pandas,
    mask_to_polygons,
    polygon_to_mask,
    trace_boundary,
)
