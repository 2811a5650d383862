from thermal3d_torch.viz.panels import (
    colorize_ir,
    overlay_rgb_thermal,
    plot_point_cloud,
    remove_black_borders,
    save_comparison_panel,
    visualize_data,
    visualize_depth_result,
    visualize_enhanced_thermal,
    visualize_ir,
    visualize_ir_standalone,
)
from thermal3d_torch.viz.sampler import (find_drive_folders, load_images_from_drive,
                                         visualize_dataset)
