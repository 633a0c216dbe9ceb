from .datasets import (BatchIterator, load_cifar10, load_image_folder,
                       prefetch_to_device, shapes_dataset, synthetic_dataset,
                       threaded_prefetch)

__all__ = ["BatchIterator", "load_cifar10", "load_image_folder",
           "prefetch_to_device", "shapes_dataset", "synthetic_dataset",
           "threaded_prefetch"]
