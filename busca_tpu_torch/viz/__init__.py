"""Debug visualization (port of ``busca_tpu.viz``)."""

from busca_tpu_torch.viz.draw import create_batch_image, id_color, plot_box

__all__ = ["plot_box", "create_batch_image", "id_color"]
