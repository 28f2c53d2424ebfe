"""k-means' nearest-centre search: distances, minimum and argmin in one
pass over the rows (kernel ``kmeans_dist``)."""
