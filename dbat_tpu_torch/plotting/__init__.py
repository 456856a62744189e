from .plots import (  # noqa: F401
    plot_coverage,
    plot_image_stats,
    plot_images,
    plot_network,
    plot_network_playback,
    plot_op_stats,
    plot_params,
)
