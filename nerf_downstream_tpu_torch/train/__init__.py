"""Loss and metrics of the segmentation task."""
