from mppi_generic_tpu_torch.maps.texture import MapTexture2D, MapTexture3D, load_track_npz

__all__ = ["MapTexture2D", "MapTexture3D", "load_track_npz"]
