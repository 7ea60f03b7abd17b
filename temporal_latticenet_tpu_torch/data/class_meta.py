"""Class metadata: label names, BGR colors and measured class
frequencies for SemanticKITTI (20/26-class) and Paris-Lille-3D (10/12).

Factual dataset content consumed by the reference through the
``colorscheme_and_labels/`` text files and the easy_pbr LabelMngr
(upstream train_ln.py:97-101).  The color scheme follows the
official SemanticKITTI map with the modifications noted in the reference
README (README.md:148).  A copy of the JAX package's ``data/class_meta.py``
(which also generates the text files in ``colorscheme_and_labels/``).
"""

import numpy as np

KITTI_LABEL_NAMES = [
    'unlabeled', 'car', 'bicycle', 'motorcycle',
    'truck', 'other-vehicle', 'person', 'bicyclist',
    'motorcyclist', 'road', 'parking', 'sidewalk',
    'other-ground', 'building', 'fence', 'vegetation',
    'trunk', 'terrain', 'pole', 'traffic-sign',
    'moving-car', 'moving-bicyclist', 'moving-person', 'moving-motorcyclist',
    'moving-truck', 'moving other-vehicle',
]

# BGR, indexed by training label id
KITTI_COLORS_BGR = [
    (0, 0, 0), (245, 150, 100), (245, 230, 100), (150, 60, 30),
    (180, 30, 80), (153, 153, 153), (30, 30, 255), (200, 40, 255),
    (90, 30, 150), (255, 0, 255), (255, 150, 255), (75, 0, 75),
    (75, 0, 175), (0, 200, 255), (50, 120, 255), (0, 175, 0),
    (0, 60, 135), (80, 240, 150), (150, 240, 255), (0, 0, 255),
    (255, 51, 0), (204, 0, 153), (58, 80, 101), (0, 51, 0),
    (102, 102, 51), (204, 204, 255),
]

# measured point-count ratios (20-class setting; trailing zeros pad the
# moving classes)
KITTI_FREQUENCIES_20 = np.array([
    0.022622173770145294, 0.054277983147765475, 0.0006269362271683171,
    0.00048826826237854476, 0.002366198345421653, 0.0014651864776299751,
    0.00019250684754856695, 5.146472952314067e-05, 1.9929806128380687e-05,
    0.21462868243010763, 0.01773798951074166, 0.12123580066382951,
    0.004457550764277597, 0.14748929551310272, 0.05926618247837518,
    0.23512048158657656, 0.006302536162552374, 0.0890906508379698,
    0.0029288628802539474, 0.0008798113583843983, 0.0,
    0.0, 0.0, 0.0,
    0.0, 0.0,
])

KITTI_FREQUENCIES_26 = np.array([
    0.031501833425347, 0.040818519255974, 0.000166095387108,
    0.000398386160151, 0.002063361210462, 0.001649719727528,
    0.000176985513385, 1.11e-08, 5.53e-09,
    0.198796487125552, 0.014717169549888, 0.14392298360372,
    0.003904855303747, 0.132686194477749, 0.072359222945622,
    0.266815021480375, 0.006035012012626, 0.078142220062718,
    0.002855498193863, 0.000615595808619, 0.001789309418528,
    0.00012709999297, 0.000160597760925, 3.75e-05,
    0.000157355876692, 0.000101578613672,
])

PL3D_LABEL_NAMES = [
    'unclassified', 'ground', 'buildings', 'signage',
    'bollards', 'trash cans', 'barriers', 'pedestrians',
    'cars', 'vegetation', 'Moving-person', 'Moving-car',
]

PL3D_COLORS_BGR = [
    (0, 0, 0), (255, 0, 255), (0, 200, 255), (0, 0, 255),
    (150, 240, 255), (75, 0, 175), (50, 120, 255), (30, 30, 255),
    (245, 150, 100), (0, 175, 0), (0, 51, 102), (255, 51, 0),
]

# the reference ships an all-zero PL3D frequency file (marked 'NOT
# CORRECT' there); kept as zeros for compatibility
PL3D_FREQUENCIES = np.zeros(12)

