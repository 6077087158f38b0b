from shapy_tpu_torch.render.rasterizer import (  # noqa: F401
    Material,
    render_mesh,
    render_mesh_overlay,
    rasterize_mesh,
    weak_persp_to_blender,
)
from shapy_tpu_torch.render.renderers import (  # noqa: F401
    COLORS,
    GTRenderer,
    HDRenderer,
    OverlayRenderer,
)
from shapy_tpu_torch.render.skeleton import (  # noqa: F401
    blend_images,
    create_bbox_img,
    create_skel_img,
    keyp_target_to_image,
    undo_img_normalization,
)
from shapy_tpu_torch.render.ply import save_ply  # noqa: F401
from shapy_tpu_torch.render.png import write_png  # noqa: F401
